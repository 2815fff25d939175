"""The training step in plain PyTorch: a frozen copy of the port's
``training/step.py`` loss terms, eager step and whitening init, on one
process, without CUDA graphs. ``TrainState`` holds the step count, the
model and its optimizer; a step updates them in place.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from portbench.reference.frozen.losses.flow import (AttributeBCELoss,
                                      AttributeRegressionLoss, RADMMMLoss)
from portbench.reference.frozen.losses.regularizers import (
    AttributeMinCrossCovarianceRegLoss, VarianceCovarianceEmbeddingRegLoss)
from portbench.reference.frozen.models.flow_decoder import squeeze_time
from portbench.reference.frozen.models.tts import TTSModel, mel_scale
from portbench.reference.frozen.ops.invertible import (whitening_params_from_stats,
                                         whitening_stats)
from portbench.reference.frozen.training.optim import Optimizer, build_optimizer
from portbench.reference.frozen.utils.masking import SeqLens


@dataclasses.dataclass
class TrainState:
    step: int
    model: TTSModel
    optimizer: Optimizer


@dataclasses.dataclass
class LossConfig:
    """Loss weights and switches (the JAX package's LossConfig)."""
    sigma: float = 1.0
    n_group_size: int = 2
    ctc_blank_logprob: float = -1.0
    binarization_loss_weight: float = 1.0
    ctc_loss_weight: float = 0.1
    f0_loss_voiced_only: bool = True
    f0_weight: float = 1.0
    energy_weight: float = 1.0
    vpred_weight: float = 1.0
    duration_weight: float = 1.0
    # 'regression' (masked MSE) or 'bce'
    f0_loss_type: str = "regression"
    energy_loss_type: str = "regression"
    vpred_loss_type: str = "bce"
    duration_loss_type: str = "regression"
    speaker_reg: Optional[Dict[str, float]] = None    # variance/covariance
    accent_reg: Optional[Dict[str, float]] = None
    cross_covariance_weight: Optional[float] = None
    binarization_start_iter: int = 20000
    kl_loss_start_iter: int = 25000


def compute_losses(model: TTSModel, cfg: LossConfig, outputs, batch,
                   binarization_on: bool):
    """Every loss term as {name: (value, weight)}."""
    in_lens = SeqLens.create(batch["input_lengths"], batch["text"].shape[1])
    out_lens = SeqLens.create(batch["output_lengths"], batch["mel"].shape[1])
    ld = RADMMMLoss(
        sigma=cfg.sigma, n_group_size=cfg.n_group_size,
        ctc_blank_logprob=cfg.ctc_blank_logprob,
        binarization_loss_weight=cfg.binarization_loss_weight,
        ctc_loss_weight=cfg.ctc_loss_weight)(
            outputs, in_lens, out_lens, binarization_on=binarization_on)

    def attr_loss(loss_type, prefix, weight):
        cls = (AttributeBCELoss if loss_type == "bce"
               else AttributeRegressionLoss)
        return cls(prefix, weight)

    if "f0_outputs" in outputs:
        mask = (batch["voiced_mask"][..., None]
                if cfg.f0_loss_voiced_only else None)
        ld.update(attr_loss(cfg.f0_loss_type, "f0_", cfg.f0_weight)(
            outputs["f0_outputs"], out_lens, mask=mask))
    if "energy_outputs" in outputs:
        ld.update(attr_loss(cfg.energy_loss_type, "energy_",
                            cfg.energy_weight)(
            outputs["energy_outputs"], out_lens))
    if "voiced_outputs" in outputs:
        ld.update(attr_loss(cfg.vpred_loss_type, "vpred_", cfg.vpred_weight)(
            outputs["voiced_outputs"], out_lens))
    if "duration_outputs" in outputs:
        ld.update(attr_loss(cfg.duration_loss_type, "duration_",
                            cfg.duration_weight)(
            outputs["duration_outputs"], None, mask=in_lens.mask[..., None]))

    spk_table = model.speaker_embeddings.weight
    use_accent = model.config.use_accent
    if cfg.speaker_reg is not None:
        ld.update(VarianceCovarianceEmbeddingRegLoss(
            "speaker", cfg.speaker_reg.get("variance", 0.0),
            cfg.speaker_reg.get("covariance", 0.0))(spk_table))
    if cfg.accent_reg is not None and use_accent:
        ld.update(VarianceCovarianceEmbeddingRegLoss(
            "accent", cfg.accent_reg.get("variance", 0.0),
            cfg.accent_reg.get("covariance", 0.0))(
                model.accent_embeddings.weight))
    if cfg.cross_covariance_weight is not None and use_accent:
        ld.update(AttributeMinCrossCovarianceRegLoss(
            "speaker", "accent", cfg.cross_covariance_weight)(
                outputs["spk_vecs"],
                outputs["accent_vecs"], spk_table,
                model.accent_embeddings.weight))
    return ld


def total_loss(loss_dict):
    return sum(v * w for v, w in loss_dict.values())


def create_train_state(model: TTSModel, device: str = "cuda",
                       **optimizer_kw) -> TrainState:
    """Step 0: the model (weights drawn from a seed or loaded) moved to
    ``device`` in train mode, and an optimizer over its parameters
    (``build_optimizer``'s keywords; RAdam, lr 1e-4, decay 1e-6, clip 1.0
    by default)."""
    model.to(torch.device(device)).train()
    return TrainState(step=0, model=model,
                      optimizer=build_optimizer(model.parameters(),
                                                **optimizer_kw))


def _metrics(ld, loss) -> Dict[str, torch.Tensor]:
    """The loss terms and the loss."""
    names = list(ld) + ["loss"]
    values = torch.stack([v.detach() for v, _ in ld.values()]
                         + [loss.detach()])
    return dict(zip(names, values.unbind()))


def _device_step(model: TTSModel, cfg: LossConfig, binarize: bool,
                 kl_on: bool) -> Callable:
    """The device work of one step, after ``optimizer.prepare``:
    ``run(state, batch, generator)`` -> metrics. It changes no host
    state that a replay of its CUDA graph would not change again, so the
    graphed step captures it whole."""

    def run(state: TrainState, batch, generator: torch.Generator):
        model.train()           # also drops the cached flow inverses
        state.optimizer.zero_grad()
        outputs = model(batch, binarize=binarize, train=True,
                        generator=generator)
        ld = compute_losses(model, cfg, outputs, batch,
                            binarization_on=(binarize and kl_on))
        loss = total_loss(ld)
        loss.backward()
        grad_norm = state.optimizer.apply()
        metrics = _metrics(ld, loss)
        metrics["grad_norm"] = grad_norm
        return metrics

    return run


def make_train_step(model: TTSModel, cfg: LossConfig, binarize: bool,
                    kl_on: bool, featurizer=None) -> Callable:
    """One eager training step: ``step(state, inputs, generator)`` ->
    (state, metrics). ``inputs`` is a featurized batch or, with a
    ``featurizer``, ``{"raw": raw}`` featurized inside the step."""
    run = _device_step(model, cfg, binarize, kl_on)

    def train_step(state: TrainState, inputs, generator):
        if featurizer is not None:
            inputs = featurizer.featurize_raw(inputs["raw"])
        state.optimizer.prepare()
        metrics = run(state, inputs, generator)
        state.step += 1
        return state, metrics

    return train_step


def make_whitening_init(model: TTSModel) -> Callable:
    """The data-dependent init of the step-0 whitening 1x1, run once
    before training: ``init(state, batch)`` sets its (upper, upper_diag,
    input_mean) from the batch's masked mel statistics and returns the
    state."""
    g = model.config.decoder.get("n_group_size", 1)

    @torch.no_grad()
    def init_pass(state: TrainState, batch):
        mel = (mel_scale(batch["mel"]) if model.config.scale_mel
               else batch["mel"])
        out_lens = SeqLens.create(batch["output_lengths"], mel.shape[1])
        mean, covar = whitening_stats(squeeze_time(mel, g),
                                      out_lens.downsample(g).mask)
        new = whitening_params_from_stats(mean, covar)
        w = model.decoder.flows[0].invtbl_conv
        w.upper.copy_(new["upper"])
        w.upper_diag.copy_(new["upper_diag"])
        w.input_mean.copy_(new["input_mean"])
        w.initialized.fill_(True)
        w.drop_inverse()
        return state

    return init_pass
