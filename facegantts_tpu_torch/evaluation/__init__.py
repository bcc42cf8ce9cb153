from facegantts_tpu_torch.evaluation.metrics import (  # noqa: F401
    composite_metric,
    log_f0_rmse,
    log_spectral_distance,
    mcd,
    speaker_similarity,
)
from facegantts_tpu_torch.evaluation.pyin import pyin  # noqa: F401
from facegantts_tpu_torch.evaluation.world import (  # noqa: F401
    dio_f0,
    fastdtw_path,
    stonemask_refine,
    world_f0,
    world_log_f0_rmse,
)
