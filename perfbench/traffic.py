"""The one traffic generator: episodes and frame scenes from a cell's
parameters and ``--seed``.

Every seed gets the same multiset of sizes (episode lengths, instruction
lengths, room sizes), in its own order, so seeds change the order of the
work and not its amount; start and goal points are drawn uniformly inside
the room.  Instructions are R2R-style sentences of an exact word count,
built from a fixed bank of clauses.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterator, List, NamedTuple, Sequence, Tuple

import numpy as np

CLAUSES = (
    "walk past the sofa", "turn left at the kitchen counter", "go up the stairs",
    "exit the bedroom through the open door", "continue down the hallway",
    "stop next to the dining table", "turn right after the bathroom",
    "walk between the two armchairs", "head toward the large window",
    "pass the bookshelf on your left", "enter the living room", "go around the coffee table",
    "wait by the fireplace", "walk out onto the balcony", "take a sharp right at the plant",
    "move forward until you reach the rug", "go through the archway",
    "stop in front of the refrigerator", "follow the corridor to the end",
    "turn around and face the piano",
)


def rng(seed: int, stream: int) -> np.random.Generator:
    """Independent streams of one seed (any non-negative whole number)."""
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def instruction(words: int, r: np.random.Generator) -> str:
    out: List[str] = []
    while len(out) < words:
        out.extend(CLAUSES[int(r.integers(len(CLAUSES)))].split())
        out[-1] = out[-1] + ("," if r.random() < 0.6 else " and")
    text = " ".join(out[:words]).rstrip(",")
    if text.endswith(" and"):
        text = text[:-4]
    return text[0].upper() + text[1:] + "."


class Episode(NamedTuple):
    steps: int
    room: Tuple[float, float]
    start: Tuple[float, float]
    goal: Tuple[float, float]
    instruction: str
    feed_seed: int


def _cycle(values: Sequence, r: np.random.Generator) -> Iterator:
    """The values in a seeded order, again and again (each pass reshuffled)."""
    while True:
        for i in r.permutation(len(values)):
            yield values[int(i)]


def episodes(traffic: Dict, seed: int) -> Iterator[Episode]:
    """Endless episodes.  ``traffic``: ``episode_steps``, ``instruction_words``
    and ``room_m`` (lists of values, each taken in a seeded order), and
    ``margin_m`` (how far start and goal keep from the walls)."""
    r_len, r_words, r_room, r_pts, r_txt = (rng(seed, s) for s in range(5))
    lens = _cycle(traffic["episode_steps"], r_len)
    words = _cycle(traffic["instruction_words"], r_words)
    rooms = _cycle(traffic["room_m"], r_room)
    m = float(traffic.get("margin_m", 0.5))
    for k in itertools.count():
        lx, lz = next(rooms)
        start = tuple(float(v) for v in r_pts.uniform([m, m], [lx - m, lz - m]))
        goal = tuple(float(v) for v in r_pts.uniform([m, m], [lx - m, lz - m]))
        yield Episode(int(next(lens)), (float(lx), float(lz)), start, goal,
                      instruction(int(next(words)), r_txt), int(r_pts.integers(1 << 31)))


def warm_episodes(traffic: Dict) -> List[Episode]:
    """Episodes that reach every prompt bucket the traffic can: the fewest
    and the most instruction words, in the largest room."""
    r = rng(0, 99)
    lx, lz = max(traffic["room_m"], key=lambda v: v[0] * v[1])
    return [Episode(int(traffic.get("warm_steps", 2)), (float(lx), float(lz)), (1.0, 1.0),
                    (lx - 1.0, lz - 1.0), instruction(int(w), r), 0)
            for w in (min(traffic["instruction_words"]), max(traffic["instruction_words"]))]

