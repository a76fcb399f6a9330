"""Parallel training of the port: one process per GPU, data parallel under
``torch.nn.parallel.DistributedDataParallel`` over the ``(data, model)``
grid of ``mesh.py``, tensor parallel over its model axis
(``sharding_rules.py``), and the scaling benchmark (``scaling.py``).
Counterpart of ``few_shot_transformer_tts_tpu/parallel/``."""

from .mesh import (Grid, agree_global_shape, check_mesh,  # noqa
                   init_distributed, local_device, make_grid,
                   process_count, process_index)
