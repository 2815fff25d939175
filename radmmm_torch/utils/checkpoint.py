"""Checkpoints: step-numbered saves, and submodules loaded and frozen.

Counterpart of ``radmmm_tpu/utils/checkpoint.py`` with ``torch.save`` in
place of orbax. A checkpoint is ``<directory>/<step>/state.pt``: the step,
the model's state_dict, and the optimizer's count and moments by parameter
name, all on the host. The reference's protocol (SURVEY.md §5):

* saves every ``iters_per_checkpoint`` steps, the oldest dropped beyond
  ``max_to_keep``;
* ``decoder_path`` / ``encoders_path`` copy named submodules from another
  run's checkpoint and freeze them (tts_lightning_modules.py:217-237);
* a save drops the frozen submodules, and a restore keeps the live values
  of whatever the checkpoint lacks (on_save_checkpoint /
  on_load_checkpoint, tts_lightning_modules.py:514-540).

Over several processes (the active ``parallel.mesh``) a checkpoint has no
layout: the parameters a rank holds a shard of, and their moments, are
gathered over its model group, rank 0 writes the full state and the
others wait at a barrier. A restore loads the full state into a full
model; the trainer then cuts each rank's shards (``mesh.shard_state``).
"""
from __future__ import annotations

import os
import shutil
from typing import Dict, Optional, Sequence

import torch

from radmmm_torch.parallel.mesh import get_mesh

ENCODER_SUBMODULES = ("text_embeddings", "text_encoder",
                      "speaker_embeddings", "attention",
                      "accent_embeddings")
STATE_FILE = "state.pt"


def _top(name: str) -> str:
    return name.split(".", 1)[0]


def _host(sd: Dict[str, torch.Tensor], exclude: Sequence[str]):
    """The full tensors of ``sd`` on the host, gathered where split."""
    mesh = get_mesh()
    return {k: mesh.gather_param(k, v).detach().to("cpu", copy=True)
            for k, v in sd.items() if _top(k) not in exclude}


def _load_file(path: str) -> dict:
    if os.path.isdir(path):
        path = os.path.join(path, STATE_FILE)
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def steps(self):
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.directory, d, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, exclude_prefixes: Sequence[str] = ()
             ) -> int:
        """Save a ``training.step.TrainState`` through host memory; frozen
        submodules (``exclude_prefixes``) are left out. Returns the bytes
        written (0 on a rank that does not write)."""
        mesh = get_mesh()
        n = 0
        # the first data rank's model group gathers; rank 0 writes
        if mesh.data_index == 0:
            payload = self._payload(state, exclude_prefixes)
            if mesh.rank == 0:
                n = self.save_payload(step, payload)
        mesh.barrier()
        return n

    def _payload(self, state, exclude_prefixes: Sequence[str]) -> dict:
        opt = state.optimizer
        names = {id(p): n for n, p in state.model.named_parameters()}
        moments = {}
        for key, bufs in (("exp_avg", opt.exp_avg),
                          ("exp_avg_sq", opt.exp_avg_sq)):
            moments[key] = _host({names[id(p)]: b for p, b in
                                  zip(opt.params, bufs)}, exclude_prefixes)
        return {
            "step": int(state.step),
            "model": _host(state.model.state_dict(), exclude_prefixes),
            "optimizer": {"count": int(opt.count), **moments}}

    def save_payload(self, step: int, payload: dict) -> int:
        """Write ``payload`` (tensors on the host) as step ``step``'s
        checkpoint, the oldest dropped beyond ``max_to_keep``. Returns the
        bytes written."""
        final = os.path.join(self.directory, str(int(step)))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        if self.max_to_keep:
            for old in self.steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        return os.path.getsize(os.path.join(final, STATE_FILE))

    def load_payload(self, step: Optional[int] = None):
        """(payload, step) of step ``step``'s checkpoint, by default the
        latest; (None, None) when there is none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        path = os.path.join(self.directory, str(int(step)))
        if not os.path.exists(os.path.join(path, STATE_FILE)):
            raise FileNotFoundError(f"no checkpoint at {path}")
        return _load_file(path), int(step)

    def restore(self, state, step: Optional[int] = None):
        """Restore into ``state`` in place -> (state, step), or (state,
        None) when there is no checkpoint. Submodules missing from the
        checkpoint keep their live values."""
        payload, step = self.load_payload(step)
        if step is None:
            return state, None
        model = state.model
        saved = payload["model"]
        for top in sorted({_top(k) for k in model.state_dict()}
                          - {_top(k) for k in saved}):
            print(f"Module {top} not loaded from checkpoint")
        model.load_state_dict(saved, strict=False)
        opt = state.optimizer
        names = {id(p): n for n, p in model.named_parameters()}
        with torch.no_grad():
            for key, bufs in (("exp_avg", opt.exp_avg),
                              ("exp_avg_sq", opt.exp_avg_sq)):
                src = payload["optimizer"][key]
                for p, b in zip(opt.params, bufs):
                    if names[id(p)] in src:
                        b.copy_(src[names[id(p)]])
        opt.count = payload["optimizer"]["count"]
        state.step = payload["step"]
        return state, step


def load_pretrained_submodules(model: torch.nn.Module, checkpoint_path: str,
                               submodule_names: Sequence[str]) -> None:
    """Copy the named top-level submodules from another checkpoint (a step
    directory or its ``state.pt``) into ``model`` (the reference's
    load_pretrained_submodules, tts_lightning_modules.py:477-497)."""
    saved = _load_file(os.path.abspath(checkpoint_path))["model"]
    picked = {k: v for k, v in saved.items() if _top(k) in submodule_names}
    model.load_state_dict(picked, strict=False)


def frozen_param_mask(model: torch.nn.Module,
                      frozen_prefixes: Sequence[str]) -> Dict[str, bool]:
    """{parameter name: True where it is frozen}."""
    return {n: _top(n) in frozen_prefixes
            for n, _ in model.named_parameters()}


def freeze_wrap(optimizer, model: torch.nn.Module,
                frozen_prefixes: Sequence[str]):
    """Freeze the parameters of the named submodules in ``optimizer``:
    they get no update and no moments that move (the reference's
    utils.freeze, utils.py:36)."""
    if frozen_prefixes:
        mask = frozen_param_mask(model, frozen_prefixes)
        names = {id(p): n for n, p in model.named_parameters()}
        optimizer.freeze([mask[names[id(p)]] for p in optimizer.params])
    return optimizer
