"""Typed hyperparameters for the PyTorch port.

An own copy of ``few_shot_transformer_tts_tpu/config.py``: the same field
names, defaults and ``k=v,...`` override grammar (ints, floats, bools, strings
and ``[a,b,c]`` lists), so one ``--hparams`` string configures both packages.
Fields that select TPU-only machinery (the PRNG implementation,
``conv_as_matmul``) are kept so such strings still parse; the port reads
only the ones its code paths use.  ``remat`` recomputes the attention and
FFN activations in the backward (``models/modules.py``); the mesh axes
shape the ``(data, model)`` grid of ranks (``parallel/mesh.py``).

``use_pallas_attention`` selects the hand-written CUDA attention kernels
(``ops/mha.py``, forward and backward) for the full-sequence attention path
on CUDA tensors; ``use_fused_layernorm`` the LayerNorm backward kernel
(``ops/layernorm.py``); ``use_pallas_decode`` the fused decode step
(``ops/decode.py``, one CUDA kernel per frame through every decoder layer)
for deterministic synthesis without self-alignments, off by default as in
the JAX package; ``use_fused_adam`` the one-pass Adam kernel
(``ops/fused_adam.py``) for the large weight matrices in training, off by
default as in the JAX package; ``wire_mel_int16`` the int16 host-to-device
copy of the mel targets in training.
``use_external_embed=True`` is rejected: the reference declares it but no code
path reads it.

``model`` selects the architecture: ``"byte2speech"`` (the default, the
reference's autoregressive ``ByteToMel``) or ``"f5tts"`` (F5-TTS,
arXiv:2410.06885: a DiT flow-matching text-to-mel sampler,
``models/f5tts.py``; synthesis only).  The ``dit_*``, ``text_*`` and
``flow_nfe`` fields are F5's widths, depths and steps, with the published
``F5TTS_Base`` values as defaults; its fixed constants (FFN and text
multipliers, position convolution, CFG strength, sway) live beside the
code that uses them (``models/f5tts.py``, ``infer/flow.py``); F5's mel
settings (100 mels at 24 kHz, hop 256, window and FFT 1024) are values of
the audio fields, set where F5 is configured.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass


MODELS = ("byte2speech", "f5tts")


@dataclass(frozen=True)
class Config:
    # ---- audio / DSP (reference hyperparams.py:4-18) ----
    num_mels: int = 80
    frame_length_ms: float = 50
    frame_shift_ms: float = 12.5
    hop_length: int = int(16000 * 0.0125)   # samples
    win_length: int = int(16000 * 0.05)     # samples
    max_db: float = 100
    ref_db: float = 20
    preemphasis: float = 0.97
    max_abs_value: float = 4.0
    symmetric_mel: bool = True
    sr: int = 16000
    n_fft: int = 2048

    # ---- synthesis / eval (reference hyperparams.py:17-22) ----
    n_iter: int = 60                 # Griffin-Lim iterations
    power: float = 1.5               # magnitude sharpening before Griffin-Lim
    max_generation_frames: int = 1100
    max_eval_batches: int = 20
    max_eval_sample_length: int = 1000
    eval_sample_per_speaker: int = 4

    # ---- model dims (reference hyperparams.py:24-35) ----
    vocab_size: int = 6000
    embed_size: int = 512
    encoder_hidden: int = 512
    decoder_hidden: int = 768
    n_encoder_layer: int = 6
    n_decoder_layer: int = 6
    n_attention_head: int = 8
    transformer_dropout_rate: float = 0.1
    decoder_dropout_rate: float = 0.5
    prenet_hidden: int = 256
    postnet_hidden: int = 512
    n_postnet_layer: int = 5

    # ---- data pipeline (reference hyperparams.py:37-50; packing budgets as
    # in the JAX package) ----
    data_format: str = "nlti"
    use_sos: bool = True
    bucket_size: int = 512
    shuffle_training_data: bool = True
    batch_frame_limit: int = 10000
    batch_frame_quad_limit: int = 14000000
    balanced_training: bool = True
    lg_prob_scale: float = 0.2
    adapt_start_step: int = 30000
    adapt_end_step: int = 30000
    final_adapt_rate: float = 0.25
    data_warmup_steps: int = 30000
    target_length_lower_bound: int = 240
    target_length_upper_bound: int = 800

    # ---- regularization (reference hyperparams.py:52) ----
    reg_weight: float = 5e-9

    # ---- speaker / language conditioning (reference hyperparams.py:54-61) ----
    multi_speaker: bool = True
    max_num_speaker: int = 1000
    speaker_embedding_size: int = 128
    multi_lingual: bool = True
    max_num_language: int = 100
    language_net_hidden: int = 128
    language_embedding_size: int = 128

    # ---- optimization (reference hyperparams.py:63-68) ----
    warmup_steps: int = 50000
    max_lr: float = 1e-3
    min_lr: float = 1e-5
    lr_decay_step: int = 550000
    lr_decay_rate: float = 1e-2
    adam_eps: float = 5e-8
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999

    # ---- external embeddings (reference hyperparams.py:70-71) ----
    external_embed_dim: int = 1024
    use_external_embed: bool = False

    # ---- additions of the JAX package (same names and defaults) ----
    # Shape lattice: (T_in, T_out, B) are padded up to these multiples.
    input_length_multiple: int = 32
    target_length_multiple: int = 64
    batch_size_multiple: int = 8
    # bf16 matmuls with fp32 accumulation; softmax and norm statistics fp32.
    use_bfloat16: bool = True
    mesh_data_axis: int = -1
    mesh_model_axis: int = 1
    # Full-sequence attention through the hand-written kernels (ops/mha.py)
    # when the tensors lie on a CUDA device.
    use_pallas_attention: bool = True
    # Fused decode step (ops/decode.py) in deterministic synthesis without
    # self-alignments.  Its kernel gives the same bits for the same inputs,
    # so a fused synthesis repeats exactly.
    use_pallas_decode: bool = False
    use_fused_adam: bool = False
    use_fused_layernorm: bool = True
    wire_mel_int16: bool = True
    conv_as_matmul: bool = False
    remat: bool = False
    prng_impl: str = "rbg"

    # ---- architecture; F5-TTS (F5TTS_Base of github.com/SWivid/F5-TTS) ----
    model: str = "byte2speech"
    dit_dim: int = 1024
    dit_depth: int = 22
    dit_heads: int = 16
    text_dim: int = 512
    text_conv_layers: int = 4
    flow_nfe: int = 32

    def __post_init__(self):
        if self.use_external_embed:
            raise ValueError(
                "use_external_embed=True has no code path (the reference "
                "declares the flag but never reads it)")
        if self.model not in MODELS:
            raise ValueError("model must be one of %s, got %r"
                             % (", ".join(MODELS), self.model))
        if self.dit_dim % self.dit_heads:
            raise ValueError("dit_dim=%d does not divide into dit_heads=%d"
                             % (self.dit_dim, self.dit_heads))
        if self.model == "f5tts" and self.mesh_model_axis > 1:
            raise ValueError("model=f5tts runs on whole layers; "
                             "mesh_model_axis must be 1, got %d"
                             % self.mesh_model_axis)

    # ------------------------------------------------------------------
    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def values(self) -> dict:
        return dataclasses.asdict(self)

    # ---- "k=v,..." override grammar (reference utils/hparams.py:157-231,401) ----
    def parse(self, spec: str) -> "Config":
        """Parse a comma-separated ``name=value`` string and return a new Config.

        Supports the reference grammar: ``a=1,b=2.0,c=True,d=hello,e=[1,2,3]``.
        Unknown keys raise ValueError; values are cast to the field's type.
        """
        if not spec:
            return self
        updates = parse_values(spec)
        fields = {f.name: f for f in dataclasses.fields(self)}
        cast = {}
        for name, raw in updates.items():
            if name not in fields:
                raise ValueError("Unknown hyperparameter: %s" % name)
            cast[name] = _cast_value(raw, fields[name].type, name)
        return dataclasses.replace(self, **cast)


# Matches "name=value" groups; value may be a bracketed list or a scalar/string.
_PARAM_RE = re.compile(
    r"""
    (?P<name>[a-zA-Z][\w\.]*)      # hyperparameter name
    \s*=\s*
    ((?P<val>[^,\[]*)              # a scalar value
     |\[(?P<vals>[^\]]*)\])        # or a [list, of, values]
    ($|,\s*)
    """,
    re.VERBOSE,
)


def parse_values(spec: str) -> dict:
    """Parse ``k=v,...`` into a dict of raw string (or list-of-string) values."""
    results = {}
    pos = 0
    while pos < len(spec):
        m = _PARAM_RE.match(spec, pos)
        if not m:
            raise ValueError("Malformed hyperparameter string: %s" % spec[pos:])
        pos = m.end()
        name = m.group("name")
        if m.group("vals") is not None:
            results[name] = [v.strip() for v in m.group("vals").split(",")]
        else:
            results[name] = m.group("val").strip()
    return results


_TRUE = {"true", "1"}
_FALSE = {"false", "0"}


def _cast_scalar(raw: str, typ, name: str):
    if typ in ("bool", bool):
        low = raw.lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
        raise ValueError("Could not parse bool for %s: %r" % (name, raw))
    if typ in ("int", int):
        return int(raw)
    if typ in ("float", float):
        return float(raw)
    return raw  # string


def _cast_value(raw, typ, name: str):
    if isinstance(typ, str):
        typ = typ.strip()
    if isinstance(raw, list):
        inner = "str"
        if isinstance(typ, str):
            m = re.match(r"List\[(\w+)\]", typ)
            if m:
                inner = m.group(1)
        return [_cast_scalar(v, inner, name) for v in raw]
    if isinstance(typ, str) and typ.startswith("Optional"):
        typ = typ[len("Optional["):-1]
    return _cast_scalar(raw, typ, name)


def default_config(**overrides) -> Config:
    return Config(**overrides)


def small_test_config(**overrides) -> Config:
    """A tiny config for CPU unit tests — same topology, small dims."""
    base = dict(
        vocab_size=300, embed_size=32, encoder_hidden=32, decoder_hidden=48,
        n_encoder_layer=2, n_decoder_layer=2, n_attention_head=4,
        prenet_hidden=16, postnet_hidden=24, n_postnet_layer=3,
        num_mels=20, max_num_speaker=16, speaker_embedding_size=8,
        max_num_language=10, language_embedding_size=8, language_net_hidden=8,
        max_generation_frames=40,
        input_length_multiple=8, target_length_multiple=8, batch_size_multiple=2,
        use_bfloat16=False, use_pallas_attention=False,
    )
    base.update(overrides)
    return Config(**base)
