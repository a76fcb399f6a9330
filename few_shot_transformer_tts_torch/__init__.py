"""few_shot_transformer_tts_torch — the PyTorch/CUDA port of the Byte2Speech
TTS system, beside the JAX package ``few_shot_transformer_tts_tpu`` that stays
its reference.

The port imports torch, numpy and scipy only; it never imports JAX or the JAX
package, and keeps its own copies of the host code it needs.  Its layout and
names mirror the JAX package module for module:

  config.py        typed hyperparameters, ``k=v,...`` grammar
  frontend/        byte-level text frontend
  data/            metadata parsing and the synthesis-only FeederEval
  models/          Byte2Speech model as nn.Modules (reference state-dict names)
  ops/             LayerNorm, the CUDA attention forward (csrc/mha_fwd.cu),
                   numpy DSP for Griffin-Lim output
  infer/           AR synthesis with KV caches
  train/           weight bridge (JAX variables / reference checkpoints)
  utils/           logging and plots
  synthesize.py    CLI: ``python -m few_shot_transformer_tts_torch.synthesize``

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from .config import Config, default_config  # noqa: F401
