from repro_torch.optim.adamw import adamw_init, adamw_update, adamw_update_, global_norm, clip_by_global_norm  # noqa: F401
from repro_torch.optim.schedules import make_schedule  # noqa: F401
from repro_torch.optim.early_stop import EarlyStopper  # noqa: F401
