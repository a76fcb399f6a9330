"""Eval-service CLI of the port, the counterpart of the JAX package's root
``eval.py`` (reference eval.py:221-251):

    python -m few_shot_transformer_tts_torch.eval --model-dir DIR \
        --log-dir DIR --data-dir DIR [--no_wait] [--hparams k=v,...] \
        [--gpu_vocoder] [--device cuda]

It watches the model dir for ``model.ckpt-<step>`` checkpoints (the port's
torch files, the JAX package's msgpack files and sharded ``.d``
directories), synthesizes the eval batches and writes DTW-MSE and
(optionally) Azure CER per language (``infer/evalservice.py``).  The flags
of the root ``eval.py``, with ``--gpu_vocoder`` in place of
``--tpu_vocoder`` (batched Griffin-Lim on the card), plus ``--device``
(default cuda; a missing card raises rather than falling back).
"""

import argparse


def str2bool(v):
    """Strict bool parser: "False" is false (the reference's ``type=bool``,
    reference eval.py:236, reads every non-empty string as true)."""
    if isinstance(v, bool):
        return v
    low = str(v).strip().lower()
    if low in ("1", "true", "yes", "y"):
        return True
    if low in ("0", "false", "no", "n", ""):
        return False
    raise argparse.ArgumentTypeError("expected a boolean, got %r" % v)


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument('--model-dir', required=True)
    parser.add_argument('--log-dir', required=True)
    parser.add_argument('--data-dir', required=True)
    parser.add_argument('--no_wait', type=str2bool, nargs='?', const=True,
                        default=False)
    parser.add_argument('--zipfilepath', type=str, default=None)
    parser.add_argument('--eval_meta', type=str, default=None)
    parser.add_argument('--eval_languages', type=str, default=None)
    parser.add_argument('--eval_speakers', type=str, default=None)
    parser.add_argument('--exclude_speakers', type=str, default=None)
    parser.add_argument('--recover_eval', type=str2bool, nargs='?', const=True,
                        default=False)
    parser.add_argument('--start_step', type=int, default=50000)
    parser.add_argument('--eval_steps', type=str, default=None)
    parser.add_argument('--eval_interval', type=int, default=10000)
    parser.add_argument('--scan_interval', type=int, default=600)
    parser.add_argument('--saver_pool', choices=['thread', 'process'],
                        default=None,
                        help='result-saver pool (default: process)')
    parser.add_argument('--gpu_vocoder', action='store_true',
                        help='run batched Griffin-Lim on the card instead '
                             'of per-sample numpy vocoding')
    parser.add_argument('--hparams', default='')
    parser.add_argument('--device', default='cuda',
                        help='torch device (default cuda; "cpu" to run there)')
    return parser


def main(argv=None):
    """Parse ``argv`` and run the eval service; its per-checkpoint
    records."""
    from few_shot_transformer_tts_torch.config import default_config
    from few_shot_transformer_tts_torch.infer import evalservice
    args, unparsed = build_parser().parse_known_args(argv)
    if unparsed:
        print('unparsed:', unparsed)
    hp = default_config().parse(args.hparams)
    return evalservice.main(args, hp)


if __name__ == '__main__':
    main()
