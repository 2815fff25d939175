"""The plain reference of a training cell whose batches carry a cached F0
track (``traffic/train_f0cache.py``): ``reference/train.py``'s compared
steps and reads over the model and featurizer of ``reference/radtts.py``
(plain PyTorch: the recurrences, the CTC DPs and MAS as Python loops, no
CUDA graph), from the same weights, raw batches, cached F0 and dropout
seed as the program."""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from portbench import weights
from portbench.reference.frozen.training.step import (LossConfig,
                                                      create_train_state,
                                                      make_train_step,
                                                      make_whitening_init)
from portbench.reference.radtts import Featurizer, TTSConfig, TTSModel
from portbench.reference.train import COMPARED_STEPS, Reads, half, tf32


def model_state(cs: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """The cell's weights from ``seed`` (``portbench/weights.py``), with
    the reference model they were drawn for."""
    model = weights.build_on(device, TTSModel, TTSConfig(**cs["tts"]))
    sd = weights.draw_state(model, seed, device, cs["weights"])
    return {"model": model, "state": sd}


def run(cs: Dict[str, Any], seed: int, raws: List[Dict[str, Any]],
        dropout_seed: int, device, lower_precision: bool = False,
        fault: Optional[str] = None) -> Dict[str, Any]:
    """The compared steps over ``raws`` (host arrays of the program's
    compared batches, one a step, each with its ``cached_f0``; ``raws[0]``
    also whitens): ``Reads``' keys. ``lower_precision`` runs it with TF32
    on (the control); ``fault`` "half_batch" drops half of every batch."""
    if len(raws) < COMPARED_STEPS:
        raise ValueError(f"{COMPARED_STEPS} batches are compared, "
                         f"{len(raws)} given")
    made = model_state(cs, seed, device)
    model = made["model"]
    model.load_state_dict(made["state"])
    del made
    optim = cs["optim"]
    state = create_train_state(
        model, device=device, optim_algo=optim["optim_algo"],
        learning_rate=optim["learning_rate"],
        weight_decay=optim["weight_decay"],
        grad_clip_val=optim["grad_clip_val"])
    feat = Featurizer(**cs["featurizer"])
    names = [n for n, _ in model.named_parameters()]
    gen = torch.Generator(device=device).manual_seed(int(dropout_seed))
    step = make_train_step(model, LossConfig(**cs["loss"]), True, True,
                           featurizer=feat)

    def up(raw):
        t = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
        return half(t) if fault == "half_batch" else t

    with tf32(lower_precision):
        make_whitening_init(model)(state, feat.featurize_raw(up(raws[0])))
        reads = Reads(names, model.parameters())
        for i in range(COMPARED_STEPS):
            reads.before()
            state, met = step(state, {"raw": up(raws[i])}, gen)
            reads.after(met, state.optimizer)
    return reads.finish()
