from repro_torch.optim.optimizers import (adafactor_init, adafactor_update,
                                          adamw_init, adamw_update,
                                          clip_by_norm, make_optimizer)
from repro_torch.optim.schedule import cosine_schedule
