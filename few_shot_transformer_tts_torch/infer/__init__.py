from .synthesize import (  # noqa: F401
    prepare_decode_inputs, synthesize_batch, save_eval_results, vocode_batch,
)
