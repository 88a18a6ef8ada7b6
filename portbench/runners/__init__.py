"""The runners of the benchmark's kinds of traffic (``train``, ``serve``)."""

from __future__ import annotations

import dataclasses


def model_config(conf: dict):
    """The program's ``ModelConfig`` of the configuration's ``model``
    object.  A key that ``ModelConfig`` lacks is refused, named: its
    ``from_dict`` would drop it, and the program would run another model
    than the configuration states."""
    from bpe_transformer_tpu_torch.models.config import ModelConfig

    known = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = sorted(set(conf["model"]) - known)
    if unknown:
        raise ValueError(f"the model keys {unknown} of configuration {conf.get('name')!r} are "
                         "not fields of the program's ModelConfig, which would drop them")
    return ModelConfig.from_dict(conf["model"])
