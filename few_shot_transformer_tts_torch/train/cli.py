"""Training CLI of the port:

    python -m few_shot_transformer_tts_torch.train --model-dir DIR \
        --log-dir DIR --data-dir DIR [--hparams k=v,...] [--device cuda]

The flags of the JAX package's root ``train.py`` (reference train.py:251-299)
plus ``--device`` (default cuda; a missing card raises rather than falling
back) and ``--dist_backend``.  ``--mirror_interval`` sets how often the
host mirror that a crash save falls back to is taken; ``--profile_dir``
writes a ``torch.profiler`` Chrome trace of steps ``[--profile_step,
--profile_step + --profile_n_steps)``, one file per rank.  Data-parallel
training runs one process per GPU:

    torchrun --nproc_per_node N -m few_shot_transformer_tts_torch.train \
        --multihost --model-dir DIR --log-dir DIR --data-dir DIR ...

``--multihost`` joins the process group from torchrun's environment over
``--dist_backend`` (default nccl on a card, gloo with ``--device cpu``; a
failed NCCL start raises, and gloo runs on a card only when asked for: it
is how one card runs two ranks).  Every checkpoint of a run of more than
one rank is a sharded ``model.ckpt-<step>.d`` directory.  With
``mesh_model_axis=M`` in ``--hparams`` the ranks form the JAX mesh's
``(data, model)`` grid and run the replicated step on it, the rows sharded
over the data index (as the JAX CLI, which has no tensor-parallel flag).
The data dir holds ``mels.zip``, ``metadata.train.txt``,
``metadata.eval.txt``, ``lang_id.json`` and ``spk_id.json``.  Checkpoints
are written as ``model.ckpt-<step>`` files in the reference torch format; a
run resumes from the latest one in ``--model-dir``.  ``--restore_from`` and
the resume also read the JAX package's msgpack and sharded ``.d``
checkpoints (``train/checkpoint.py:load_state``), Adam moments included.
"""

import argparse


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument('--model-dir', required=True,
                        help="Directory to save checkpoints and resume")
    parser.add_argument('--log-dir', required=True,
                        help="Directory to save logs and metrics")
    parser.add_argument('--data-dir', required=True,
                        help="Directory with data and metadata")
    parser.add_argument('--zipfilepath', type=str, default=None)
    parser.add_argument('--train_meta', type=str, default=None)
    parser.add_argument('--eval_meta', type=str, default=None)
    parser.add_argument('--adapt_languages', type=str, default=None)
    parser.add_argument('--adapt_speakers', type=str, default=None)
    parser.add_argument('--training_languages', type=str, default=None)
    parser.add_argument('--training_speakers', type=str, default=None)
    parser.add_argument('--eval_languages', type=str, default=None)
    parser.add_argument('--eval_speakers', type=str, default=None)
    parser.add_argument('--warmup_languages', type=str, default=None)
    parser.add_argument('--warmup_speakers', type=str, default=None)
    parser.add_argument('--exclude_speakers', type=str, default=None)
    parser.add_argument('--adapt_samples', type=str, default=None)
    parser.add_argument('--downsample_languages', type=str, default=None)
    parser.add_argument('--eval_steps', type=str, default=None)
    parser.add_argument('--checkpoint_interval', type=int, default=10000)
    parser.add_argument('--summary_interval', type=int, default=100)
    parser.add_argument('--log_interval', type=int, default=50,
                        help='steps between batched device->host loss '
                             'fetches; every step still gets a log line, '
                             'emitted in bursts')
    parser.add_argument('--restore_from', default=None)
    parser.add_argument('--hparams', default='', help='k=v,... overrides')
    parser.add_argument('--max_steps', type=int, default=None)
    parser.add_argument('--mirror_interval', type=int, default=1000,
                        help='steps between host mirrors of the state, '
                             'which a crash save writes when the live state '
                             'cannot be fetched')
    parser.add_argument('--seed', type=int, default=0,
                        help='weights and dropout draws')
    parser.add_argument('--device', default='cuda',
                        help='torch device (default cuda; "cpu" to run there)')
    parser.add_argument('--multihost', action='store_true',
                        help='data-parallel training under torchrun: join '
                             'its process group, one process per GPU')
    parser.add_argument('--dist_backend', choices=('nccl', 'gloo'),
                        default=None,
                        help='process group backend with --multihost '
                             '(default nccl on a card, gloo on the CPU)')
    parser.add_argument('--profile_dir', default=None,
                        help='write a torch.profiler trace here')
    parser.add_argument('--profile_step', type=int, default=50)
    parser.add_argument('--profile_n_steps', type=int, default=5)
    return parser


def main(argv=None):
    from few_shot_transformer_tts_torch.config import default_config
    from few_shot_transformer_tts_torch.train.loop import train
    args, unparsed = build_parser().parse_known_args(argv)
    if unparsed:
        print('unparsed:', unparsed)
    hp = default_config().parse(args.hparams)
    if hp.model == 'f5tts':
        raise ValueError('training model=f5tts is not ported')
    return train(args, hp)
