"""few_shot_transformer_tts_torch — the PyTorch/CUDA port of the Byte2Speech
TTS system, beside the JAX package ``few_shot_transformer_tts_tpu`` that stays
its reference.

The port imports torch, numpy and scipy only; it never imports JAX or the JAX
package, and keeps its own copies of the host code it needs.  Its layout and
names mirror the JAX package module for module:

  config.py        typed hyperparameters, ``k=v,...`` grammar
  frontend/        byte-level text frontend
  data/            metadata, the zip mel store, Feeder and FeederEval
  models/          Byte2Speech model as nn.Modules (reference state-dict
                   names), loss and LR schedule
  ops/             attention forward/backward (csrc/mha_fwd.cu,
                   csrc/mha_bwd.cu), LayerNorm with its backward kernel
                   (csrc/layernorm_bwd.cu), numpy DSP for Griffin-Lim output
  infer/           AR synthesis with KV caches, the eval service
  train/           train step and loop, checkpoints (the JAX package's
                   msgpack and sharded ones read too), weight bridge (JAX
                   variables / reference checkpoints), the training CLI
                   ``python -m few_shot_transformer_tts_torch.train``
  utils/           logging, plots, metric windows, DTW-MSE and CER
  synthesize.py    CLI: ``python -m few_shot_transformer_tts_torch.synthesize``
  eval.py          CLI: ``python -m few_shot_transformer_tts_torch.eval``

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from .config import Config, default_config  # noqa: F401
