"""Record feed episodes to ``.npz`` for ``RecordedEpisodeFeed`` replay.

    python -m dynam3d_torch.tools.record_episodes --out DIR [--episodes 3]

Port of ``tools/record_episodes.py``: each step's posed RGB-D observation
is captured so a replay needs no simulator.  ``record`` works with any feed
of the Feed protocol; ``main`` records ``SyntheticRoomFeed`` episodes under
a greedy teacher over the oracle's candidate fan.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from dynam3d_torch.runtime.feed import STOP, SyntheticRoomFeed


def record(feed, policy_fn, max_steps: int, out_path: str) -> int:
    """Roll one episode, record per-step observations, save npz; returns
    the number of steps recorded.

    ``policy_fn(obs, t) -> action`` decides the motion (e.g. a teacher).
    """
    obs = feed.reset()
    rgbs, depths, poss, hds = [], [], [], []
    for t in range(max_steps):
        rgbs.append(obs.rgb)
        depths.append(obs.depth)
        poss.append(obs.position)
        hds.append(obs.heading)
        action = policy_fn(obs, t)
        obs, done, _ = feed.step(action)
        if done:
            break
    extra = {}
    if getattr(feed, "goal", None) is not None:
        extra["goal"] = np.asarray(feed.goal, np.float32)
    np.savez_compressed(
        out_path,
        rgb=np.stack(rgbs),
        depth=np.stack(depths),
        position=np.stack(poss),
        heading=np.asarray(hds, np.float32),
        instruction=obs.instruction,
        gt_locations=np.stack(poss),
        **extra,
    )
    return len(rgbs)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True, help="directory for ep{i}.npz")
    p.add_argument("--episodes", type=int, default=3)
    p.add_argument("--max-steps", type=int, default=10)
    p.add_argument("--rgb-size", type=int, default=336)
    p.add_argument("--depth-size", type=int, default=256)
    args = p.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    cands = [(a, d) for a in np.linspace(0, 2 * np.pi, 12, endpoint=False)
             for d in (0.25, 0.75, 1.5)]
    for e in range(args.episodes):
        feed = SyntheticRoomFeed(rgb_size=args.rgb_size, depth_size=args.depth_size, seed=e)

        def teacher(obs, t, feed=feed):
            # greedy teacher: the best of the candidate fan
            dists = [feed.cand_dist_to_goal(a, d) for a, d in cands]
            if feed.oracle_distance() < 1.5:
                return STOP
            return cands[int(np.argmin(dists))]

        path = os.path.join(args.out, f"ep{e}.npz")
        n = record(feed, teacher, args.max_steps, path)
        print(f"episode {e}: {n} steps -> {path}")


if __name__ == "__main__":
    main()
