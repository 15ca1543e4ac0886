"""A configuration file as the program runs it.

The benchmark makes the weights itself (the family's ``draw_params`` in
``reference/``), on the device, in the types they are served in, a few
large draws (one per stacked leaf), and hands the same tensors to the
program (in the program's parameter tree) and to the reference (which
reads them in float32). It never calls the program's own initialisation.
"""
from __future__ import annotations


def port_config(conf: dict):
    """The program's ``ModelConfig`` from a configuration file's ``port``
    section."""
    from repro_torch.configs.base import LayerSpec, ModelConfig

    fields = dict(conf["port"])
    fields["block"] = tuple(LayerSpec(**b) for b in fields["block"])
    return ModelConfig(**fields)
