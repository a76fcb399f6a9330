from .feeder import Feeder, FeederEval  # noqa: F401
from .metadata import (  # noqa: F401
    read_meta, group_meta, downsample_language, filter_eval_samples,
    speaker_of,
)
