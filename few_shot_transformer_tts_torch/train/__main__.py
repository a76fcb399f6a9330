"""``python -m few_shot_transformer_tts_torch.train``: see ``train/cli.py``."""

from few_shot_transformer_tts_torch.train.cli import main

if __name__ == '__main__':
    main()
