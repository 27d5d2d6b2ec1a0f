"""Action text <-> (angle, distance); own copy of ``utils/actions.py``
(``EpisodeActionState``, ``parse_action``)."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

from dynam3d_torch.config import ActionConfig

STOP = -100


@dataclass
class EpisodeActionState:
    keep_target_waypoint: Optional[Tuple[float, float]] = None
    history_actions: List[str] = field(default_factory=lambda: ["none\n"] * 4)

    def push_history(self, action_text: str) -> None:
        self.history_actions.pop(0)
        self.history_actions.append(action_text)


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
