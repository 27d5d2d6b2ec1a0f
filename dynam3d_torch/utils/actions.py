"""Action text <-> (angle, distance); own copy of ``utils/actions.py``
(``EpisodeActionState``, ``gt_text``, ``parse_action``,
``teacher_targets``).  Quantization: 15 degrees / 0.25 m a step, at most 4
turn steps an action."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple, Union

from dynam3d_torch.config import ActionConfig

STOP = -100


@dataclass
class EpisodeActionState:
    keep_target_waypoint: Optional[Tuple[float, float]] = None
    history_actions: List[str] = field(default_factory=lambda: ["none\n"] * 4)

    def push_history(self, action_text: str) -> None:
        self.history_actions.pop(0)
        self.history_actions.append(action_text)


def gt_text(state: EpisodeActionState, target_angle: float, target_distance: float,
            stop_action: bool, cfg: ActionConfig = ActionConfig()) -> str:
    """Teacher action -> label text.  A turn of ``max_turn_steps`` or more
    steps (and less than a full circle) is split: this step turns and
    ``state.keep_target_waypoint`` carries the rest to the next one.  A turn
    prefix equal to those at history slots -2, -3 and -4 becomes
    ``"error."`` (a looping episode)."""
    aps, dps, mts = cfg.angle_per_step_deg, cfg.distance_per_step, cfg.max_turn_steps
    if stop_action:
        text = "stop.<|end|>"
    else:
        turn_angle = round(math.degrees(target_angle))
        move = target_distance
        turn_steps = round(turn_angle / aps)
        left = (f"turn left {round(turn_angle / aps)} steps,"
                f" move {round(move / dps)} steps.<|end|>")
        right = (f"turn right {round((360 - turn_angle) / aps)} steps,"
                 f" move {round(move / dps)} steps.<|end|>")
        if mts <= turn_steps < 360 // aps:
            if turn_steps < 180 // aps:
                text = left
                rest = turn_angle - mts * aps
            else:
                text = right
                rest = turn_angle + mts * aps
            state.keep_target_waypoint = (
                (math.radians(rest) + 2 * math.pi) % (2 * math.pi), move)
        else:
            text = left if turn_steps < mts else right
            state.keep_target_waypoint = None

    n = len("turn left 4 steps")
    h = state.history_actions
    if h[-2][:n] == text[:n] and h[-4][:n] == text[:n] and h[-3][:n] == text[:n]:
        text = "error.<|end|>"
    return text


def parse_action(text: str, cfg: ActionConfig = ActionConfig()
                 ) -> Union[int, Tuple[float, float]]:
    """Generated text -> ``(angle_rad, distance_m)`` or ``STOP``: turns clamp
    to ``max_turn_steps``; the move is parsed only below that count."""
    aps, dps, mts = cfg.angle_per_step_deg, cfg.distance_per_step, cfg.max_turn_steps
    angle = distance = 0.0
    if "stop" in text or "error" in text:
        return STOP
    steps = None
    if "left" in text:
        start = text.find("left") + len("left")
        end = text.find("steps,")
        if end == -1:
            return STOP
        steps = int(text[start:end])
        angle = math.radians(min(mts, steps) * aps)
    elif "right" in text:
        start = text.find("right") + len("right")
        end = text.find("steps,")
        if end == -1:
            return STOP
        steps = int(text[start:end])
        angle = 2.0 * math.pi - math.radians(min(mts, steps) * aps)
    if "move" in text and steps is not None and steps < mts:
        mstart = text.find("move") + len("move")
        mend = text.find("steps.")
        if mend != -1:
            distance = int(text[mstart:mend]) * dps
    return (angle, distance)


def teacher_targets(state: EpisodeActionState, cand_angles: Sequence[float],
                    cand_distances: Sequence[float], oracle_idx: int
                    ) -> Tuple[float, float, bool]:
    """``(angle, distance, stop)`` of the teacher waypoint: ``STOP`` as the
    oracle index means stop; a held-over split turn overrides the oracle
    candidate."""
    if oracle_idx == STOP:
        return 0.0, 0.0, True
    if state.keep_target_waypoint is not None:
        a, d = state.keep_target_waypoint
        return a, d, False
    return cand_angles[oracle_idx], cand_distances[oracle_idx], False
