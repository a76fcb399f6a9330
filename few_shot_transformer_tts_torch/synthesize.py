"""Synthesis CLI of the port: checkpoint + script -> wavs and mels.

    python -m few_shot_transformer_tts_torch.synthesize \
        --checkpoint model.ckpt-<step> --script script.txt \
        --data-dir DIR_WITH_lang_id.json_AND_spk_id.json \
        --output-dir OUT [--hparams k=v,...] [--deterministic] [--device cuda]

Script lines are ``SPEAKERNAME_FILEID|DUMMY_LENGTH|TEXT|LANG``.  Flags as in
the JAX package's root ``synthesize.py`` plus ``--device`` (default cuda; a
missing card raises rather than falling back).  The checkpoint is a
``torch.save({model, optim, sched, step})`` file, a JAX package msgpack
``model.ckpt-<step>`` or a sharded ``model.ckpt-<step>.d`` directory
(``train/checkpoint.py:load_state``).  Fp32 matmuls and convolutions run
without TF32.  ``--hparams use_pallas_decode=True --deterministic`` decodes each frame with
the fused decode kernel (``ops/decode.py``), one launch per frame through
every decoder layer.

F5-TTS (``--hparams model=f5tts,...``) synthesises from a voice prompt
instead of a script:

    python -m few_shot_transformer_tts_torch.synthesize \
        --hparams model=f5tts,num_mels=100,sr=24000,hop_length=256,... \
        --prompt PROMPT.npy|PROMPT.wav --prompt_text TEXT --text TEXT \
        --output-dir OUT [--checkpoint STATE_DICT.pt] [--seed N]

The prompt is a [frames, num_mels] mel ``.npy`` or a wav (its mel through
the port's DSP, ``ops/dsp.py:get_spectrograms``).  ``--checkpoint`` is a
``torch.save`` of the model's state dict; without it the weights are
random from ``--seed`` (no published checkpoint ships with the port).  It
writes ``f5tts.npy`` (the mel, prompt frames included) and a Griffin-Lim
``f5tts.wav``.
"""

import argparse
import json
import logging
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--checkpoint',
                        help='model.ckpt-<step>: a torch file, a JAX '
                             'msgpack file or a sharded .d directory '
                             '(model=f5tts: a state dict; optional)')
    parser.add_argument('--script',
                        help='metadata file: name|dummy_len|text|lang per line')
    parser.add_argument('--data-dir',
                        help='directory with lang_id.json / spk_id.json')
    parser.add_argument('--prompt', help='model=f5tts: the voice prompt, a '
                        '[frames, num_mels] .npy mel or a wav')
    parser.add_argument('--prompt_text', help='model=f5tts: its text')
    parser.add_argument('--text', help='model=f5tts: the text to speak')
    parser.add_argument('--seed', type=int, default=0,
                        help='model=f5tts: the noise (and, without '
                             '--checkpoint, the weights)')
    parser.add_argument('--output-dir', required=True)
    parser.add_argument('--hparams', default='')
    parser.add_argument('--deterministic', action='store_true',
                        help='disable decoder dropout (reference keeps it on)')
    parser.add_argument('--device', default='cuda',
                        help='torch device (default cuda; "cpu" to run there)')
    args = parser.parse_args(argv)

    from few_shot_transformer_tts_torch.config import default_config
    from few_shot_transformer_tts_torch.data import FeederEval
    from few_shot_transformer_tts_torch.infer import (synthesize_batch,
                                                      save_eval_results)
    from few_shot_transformer_tts_torch.models import ByteToMel
    from few_shot_transformer_tts_torch.train import checkpoint as ckpt_lib
    from few_shot_transformer_tts_torch.utils import infolog

    infolog.set_logger()
    hp = default_config().parse(args.hparams)
    if hp.model == 'f5tts':
        return synthesize_f5(args, hp, parser)
    for flag in ('checkpoint', 'script', 'data_dir'):
        if getattr(args, flag) is None:
            parser.error('--%s is required' % flag.replace('_', '-'))
    with open(os.path.join(args.data_dir, 'lang_id.json')) as f:
        lang_to_id = json.load(f)
    with open(os.path.join(args.data_dir, 'spk_id.json')) as f:
        spk_to_id = json.load(f)

    fmt = ckpt_lib.checkpoint_format(args.checkpoint)
    feeder = FeederEval(None, args.script, hp, spk_to_id=spk_to_id,
                        lang_to_id=lang_to_id, shuffle=False, keep_order=True)
    model = ByteToMel(hp, device=args.device)
    step = ckpt_lib.load_state(args.checkpoint, model)
    model.eval()
    logging.info('Loaded %s checkpoint at step %d on %s', fmt, step,
                 model.device)

    os.makedirs(args.output_dir, exist_ok=True)
    for batch in feeder.fetch_data():
        results = synthesize_batch(model, batch, hp,
                                   deterministic=args.deterministic)
        save_eval_results(**results, output_dir=args.output_dir, hp=hp,
                          save_trimmed_wave=True)


def synthesize_f5(args, hp, parser):
    """One F5-TTS utterance: the prompt, its text and the target text to
    ``<output-dir>/f5tts.npy`` and ``.wav``."""
    import numpy as np
    import torch
    from few_shot_transformer_tts_torch.infer import synthesize_batch
    from few_shot_transformer_tts_torch.models.f5tts import F5TTS
    from few_shot_transformer_tts_torch.ops import dsp

    for flag in ('prompt', 'prompt_text', 'text'):
        if getattr(args, flag) is None:
            parser.error('model=f5tts needs --%s' % flag)
    if args.prompt.endswith('.npy'):
        prompt = np.load(args.prompt).astype(np.float32)
    else:
        prompt = dsp.get_spectrograms(dsp.load_wav(args.prompt, hp.sr), hp)
    if prompt.ndim != 2 or prompt.shape[1] != hp.num_mels:
        raise ValueError('the prompt mel must be [frames, %d], got %s'
                         % (hp.num_mels, prompt.shape))
    torch.manual_seed(args.seed)
    model = F5TTS(hp, device=args.device)
    if args.checkpoint:
        model.load_state_dict(torch.load(args.checkpoint,
                                         map_location=model.device))
    model.eval()
    prompt_bytes = args.prompt_text.encode('utf-8')
    text = prompt_bytes + args.text.encode('utf-8')
    batch = {'inputs': [list(text)], 'input_lengths': [len(text)],
             'prompt_bytes': [len(prompt_bytes)], 'prompt_mels': [prompt],
             'names': ['f5tts']}
    gen = torch.Generator(model.device)
    gen.manual_seed(args.seed)
    out = synthesize_batch(model, batch, hp, generator=gen)
    n = out['generated_lengths'][0]
    mel = out['mel_aft'][0][:n]
    os.makedirs(args.output_dir, exist_ok=True)
    np.save(os.path.join(args.output_dir, 'f5tts.npy'), mel)
    dsp.save_wav(dsp.mel2wav(mel, hp),
                 os.path.join(args.output_dir, 'f5tts.wav'), hp.sr)
    logging.info('F5-TTS: %d frames (%d of the prompt) to %s', n,
                 len(prompt), args.output_dir)
    return out


if __name__ == '__main__':
    main()
