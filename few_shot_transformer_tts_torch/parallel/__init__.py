"""Data-parallel training of the port: one process per GPU under
``torch.nn.parallel.DistributedDataParallel`` (``mesh.py``) and its scaling
benchmark (``scaling.py``).  Counterpart of
``few_shot_transformer_tts_tpu/parallel/``."""

from .mesh import (agree_global_shape, check_mesh, init_distributed,  # noqa
                   local_device, make_stats_group, process_count,
                   process_index)
