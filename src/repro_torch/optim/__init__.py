"""AdamW written out by hand over nested-dict parameter trees."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     clip_by_global_norm, cosine_schedule, global_norm,
                                     opt_pspecs)
