"""The benchmark of the PyTorch/CUDA port (``few_shot_transformer_tts_torch``);
see README.md.  Imports nothing of JAX or of the JAX package."""
