"""The plain reference and the comparisons that decide ``correct``. Imports
nothing of the program, of ``jax`` or of the JAX package.

A configuration file names its model family under ``"reference"``; the
family's module here, ``<family>.py``, draws the weights into the
program's tree and holds the family's plain equations. ``plain.py`` holds
the pieces every family shares."""
import importlib


def family(conf: dict):
    """The reference module of the configuration's model family."""
    return importlib.import_module(f"{__name__}.{conf['reference']}")
