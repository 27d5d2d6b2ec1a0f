"""Build the two golden episodes that ``RecordedEpisodeFeed`` replays.

    python -m dynam3d_torch.tools.make_golden_fixtures --out DIR

Port of ``tools/make_golden_fixtures.py``, with the same recipe:

  - ``golden_box_ep.npz``: a convex ``SyntheticRoomFeed`` room (seed 11,
    at most 12 steps);
  - ``golden_floorplan_ep.npz``: the non-convex ``FloorplanFeed``
    apartment (seed 12, at most 24 steps), where the teacher must route
    through a doorway (geodesic != euclidean).

Deterministic: a greedy teacher over the oracle's candidate fan, 56² RGB
and 32² depth.  ``--out`` is required; nothing is written elsewhere.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from dynam3d_torch.runtime.feed import STOP, FloorplanFeed, SyntheticRoomFeed
from dynam3d_torch.tools.record_episodes import record


def greedy_teacher(feed):
    """STOP within 1 m of the goal, else the candidate of 12 headings x 3
    ranges whose move ends nearest the goal by the feed's oracle."""
    cands = [
        (a, d)
        for a in np.linspace(0, 2 * np.pi, 12, endpoint=False)
        for d in (0.25, 0.75, 1.5)
    ]

    def teacher(obs, t):
        if feed.oracle_distance() < 1.0:
            return STOP
        dists = [feed.cand_dist_to_goal(a, d) for a, d in cands]
        return cands[int(np.argmin(dists))]

    return teacher


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True, help="directory for the two .npz files")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    box = SyntheticRoomFeed(rgb_size=56, depth_size=32, seed=11)
    n = record(box, greedy_teacher(box), 12, os.path.join(args.out, "golden_box_ep.npz"))
    print(f"golden_box_ep: {n} steps")

    flo = FloorplanFeed(rgb_size=56, depth_size=32, seed=12)
    n = record(flo, greedy_teacher(flo), 24, os.path.join(args.out, "golden_floorplan_ep.npz"))
    print(f"golden_floorplan_ep: {n} steps, final geodesic {flo.oracle_distance():.2f} m")


if __name__ == "__main__":
    main()
