"""The plain reference of a training cell: the frozen model, loss, RAdam
and featurizer of ``reference/frozen`` (plain PyTorch: the recurrences,
the CTC DPs and MAS as Python loops, no CUDA graph), driven through the
cell's compared steps from the same weights, raw batches and dropout
seed as the program, and read as the program is read (``Reads``)."""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional

import torch

from portbench import weights
from portbench.reference.frozen.data.collate import Featurizer
from portbench.reference.frozen.models.tts import TTSConfig, TTSModel
from portbench.reference.frozen.training.step import (LossConfig,
                                                      create_train_state,
                                                      make_train_step,
                                                      make_whitening_init)

# the steps compared, each on a batch of its own: RAdam's counts 1-5 take
# its unrectified branch, 6-8 the rectified one that a training window
# replays (in the program: its warm-up, its capture, which replays, and a
# plain replay)
COMPARED_STEPS = 8
# the first steps, whose change is compared as a whole
FIRST_STEPS = 3


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 in matmuls and cuDNN convolutions inside when ``on`` (the
    control's lower precision); the previous settings after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def model_state(cs: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """The cell's weights from ``seed`` (``portbench/weights.py``), with
    the frozen model they were drawn for."""
    model = weights.build_on(device, TTSModel, TTSConfig(**cs["tts"]))
    sd = weights.draw_state(model, seed, device, cs["weights"])
    return {"model": model, "state": sd}


def leaf_norms(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack([t.detach().double().norm() for t in tensors])


class Reads:
    """What is read of the compared steps, on either side: each step's
    loss terms and RAdam branch, each leaf's norm of the first gradient as
    RAdam took it (exp_avg / (1 - b1) after step 1), of the change over
    the first FIRST_STEPS steps, and of the change over the rectified
    steps (from before the first of them to the end)."""

    def __init__(self, names: List[str], params):
        self.params = list(params)
        self.start = self._copy()
        self.prev = self.rect0 = None
        self.out: Dict[str, Any] = {"names": list(names), "losses": [],
                                    "rectified": []}

    def _copy(self) -> List[torch.Tensor]:
        return [p.detach().clone() for p in self.params]

    def _change(self, since: List[torch.Tensor]) -> List[float]:
        return leaf_norms([p - q for p, q in zip(self.params, since)]
                          ).cpu().tolist()

    def before(self) -> None:
        """Before each compared step, until the first rectified one."""
        if self.rect0 is None:
            self.prev = self._copy()

    def after(self, met: Dict[str, torch.Tensor], optimizer) -> None:
        i = len(self.out["losses"])
        terms = [k for k in met if k != "grad_norm"]
        self.out["terms"] = terms
        self.out["losses"].append([float(met[k]) for k in terms])
        self.out["rectified"].append(bool(optimizer.rectified))
        if i == 0:
            self.out["grad"] = leaf_norms(
                [m / (1 - optimizer.b1) for m in optimizer.exp_avg]
            ).cpu().tolist()
        if i == FIRST_STEPS - 1:
            self.out["change"] = self._change(self.start)
            self.start = None
        if optimizer.rectified and self.rect0 is None:
            self.rect0 = self.prev
        self.prev = None

    def finish(self) -> Dict[str, Any]:
        self.out["rect_change"] = (None if self.rect0 is None
                                   else self._change(self.rect0))
        self.rect0 = None
        return self.out


def half(raw: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The batch's first half of rows: a fault, the mean taken over the
    rest."""
    n = next(iter(raw.values())).shape[0] // 2
    return {k: v[:n] for k, v in raw.items()}


def run(cs: Dict[str, Any], seed: int, raws: List[Dict[str, Any]],
        dropout_seed: int, device, lower_precision: bool = False,
        fault: Optional[str] = None) -> Dict[str, Any]:
    """The compared steps over ``raws`` (host arrays of the program's
    first raw batches, one a step; ``raws[0]`` also whitens), from the
    weights of ``seed``: ``Reads``' keys. ``lower_precision`` runs it
    with TF32 on (the control); ``fault`` "half_batch" drops half of
    every batch."""
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
    loss_cfg = LossConfig(**cs["loss"])
    names = [n for n, _ in model.named_parameters()]
    gen = torch.Generator(device=device).manual_seed(int(dropout_seed))
    step = make_train_step(model, loss_cfg, True, True, featurizer=feat)

    def up(raw):
        t = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
        return half(t) if fault == "half_batch" else t

    with tf32(lower_precision):
        make_whitening_init(model)(state, feat.featurize_raw(up(raws[0]),
                                                             None))
        reads = Reads(names, model.parameters())
        for i in range(COMPARED_STEPS):
            reads.before()
            state, met = step(state, {"raw": up(raws[i])}, gen)
            reads.after(met, state.optimizer)
    return reads.finish()
