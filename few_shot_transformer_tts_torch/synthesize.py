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
"""

import argparse
import json
import logging
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--checkpoint', required=True,
                        help='model.ckpt-<step>: a torch file, a JAX '
                             'msgpack file or a sharded .d directory')
    parser.add_argument('--script', required=True,
                        help='metadata file: name|dummy_len|text|lang per line')
    parser.add_argument('--data-dir', required=True,
                        help='directory with lang_id.json / spk_id.json')
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


if __name__ == '__main__':
    main()
