from .feeder import FeederEval  # noqa: F401
from .metadata import read_meta, filter_eval_samples, speaker_of  # noqa: F401
