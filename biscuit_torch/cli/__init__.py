"""The port's CLI scripts: counterparts of the reference's repo-root
configure.py / train.py / results.py and of the servable export and
scoring (``biscuit_tpu/cli/``), run as::

    python -m biscuit_torch.cli.configure --help
    python -m biscuit_torch.cli.train --help      # --device cpu off the card
    python -m biscuit_torch.cli.results --help
    python -m biscuit_torch.cli.export --help     # --device cpu off the card
    python -m biscuit_torch.cli.predict --help

They need click (and the figures matplotlib and seaborn); no other
module of the port imports them.
"""
