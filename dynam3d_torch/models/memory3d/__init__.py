from dynam3d_torch.models.memory3d.params import init_field_params
from dynam3d_torch.models.memory3d.query import environment_features
from dynam3d_torch.models.memory3d.state import FieldState, init_state
from dynam3d_torch.models.memory3d.update import (
    delete_from_frustum, update_view, update_views,
)

__all__ = [
    "FieldState", "init_state", "init_field_params", "update_view",
    "update_views", "delete_from_frustum", "environment_features",
]
