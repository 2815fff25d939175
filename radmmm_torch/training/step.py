"""The training and validation steps: loss terms, gradients, optimizer,
phases, and the whitening init.

Counterpart of ``radmmm_tpu/training/step.py``. PyTorch keeps the
parameters in the model and the moments in the optimizer, so a
``TrainState`` holds the step count, the model and its optimizer, and a
step updates them in place. Where the JAX step takes a dropout key, this
one takes a ``torch.Generator`` on the model's device. The step functions
act on the model they were made for; the state is what a checkpoint
saves and resumes (``convert.load_jax_train_state``). Each step puts the
model in train mode, which drops its cached flow inverses, so sampling
after a step uses the new weights. A training step's forward also moves
the batch norms' running statistics (the spline couplings', buffers of
the model), as the JAX step's mutable ``batch_stats`` does; the
validation step normalises with them. The phase flags (binarize, kl_on)
are plain Python booleans, one step function per phase, as in the JAX
package.

Under a data mesh (``parallel.mesh.use_mesh``) the step computes what the
JAX step computes on the global batch from this rank's share of it: each
loss term is the rank's share (``losses/flow.py``; a term every rank
computes whole, as the table regularizers, counts 1/n_data on each), the
gradients are summed over the data group, so they are the gradient of the
global loss, and the metrics are summed likewise, so every rank logs the
global values. Under tensor parallelism the replicated parameters'
gradients are averaged over the model group, so its ranks stay alike.
The whitening init's moments are the global batch's.

    model = TTSModel(default_radmmm_config())
    state = create_train_state(model)            # to CUDA, RAdam, clip 1.0
    make_whitening_init(model)(state, batch)     # batch on the same device
    step = make_train_step(model, LossConfig(), binarize=True, kl_on=True)
    state, metrics = step(state, batch, torch.Generator("cuda"))

Given a ``GraphPool``, ``make_train_step`` and ``make_val_step`` run
through ``utils/graphs.Graphed``: on the card a signature's first call is
eager, its second is captured as a CUDA graph and replayed, later calls
replay (the trainer's steps, on one card and over NCCL).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

# the host side of make_train_megastep, as the JAX package's step module
# has it
from radmmm_torch.data.loader import stack_raw_batches  # noqa: F401
from radmmm_torch.losses.flow import (AttributeBCELoss,
                                      AttributeRegressionLoss, RADMMMLoss)
from radmmm_torch.losses.regularizers import (
    AttributeMinCrossCovarianceRegLoss, VarianceCovarianceEmbeddingRegLoss)
from radmmm_torch.models.flow_decoder import squeeze_time
from radmmm_torch.models.tts import TTSModel, mel_scale
from radmmm_torch.ops.invertible import (whitening_params_from_stats,
                                         whitening_stats)
from radmmm_torch.parallel import mesh
from radmmm_torch.training.optim import Optimizer, build_optimizer
from radmmm_torch.utils.device import resolve_device
from radmmm_torch.utils.graphs import Graphed, GraphPool
from radmmm_torch.utils.masking import SeqLens
from radmmm_torch.utils.profiling import device_span


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


def _whole(loss_dict):
    """A term every data rank computes whole: each holds 1/n_data of it."""
    k = mesh.n_data()
    return loss_dict if k == 1 else {
        name: (v / k, w) for name, (v, w) in loss_dict.items()}


def compute_losses(model: TTSModel, cfg: LossConfig, outputs, batch,
                   binarization_on: bool):
    """Every loss term as {name: (value, weight)}: this rank's share of it
    over the global batch (the term itself in one process)."""
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
        ld.update(_whole(VarianceCovarianceEmbeddingRegLoss(
            "speaker", cfg.speaker_reg.get("variance", 0.0),
            cfg.speaker_reg.get("covariance", 0.0))(spk_table)))
    if cfg.accent_reg is not None and use_accent:
        ld.update(_whole(VarianceCovarianceEmbeddingRegLoss(
            "accent", cfg.accent_reg.get("variance", 0.0),
            cfg.accent_reg.get("covariance", 0.0))(
                model.accent_embeddings.weight)))
    if cfg.cross_covariance_weight is not None and use_accent:
        # the batch's cross-covariance is not a sum over items: it reads
        # the global batch's vectors, gathered with their gradient
        ld.update(_whole(AttributeMinCrossCovarianceRegLoss(
            "speaker", "accent", cfg.cross_covariance_weight)(
                mesh.data_gather(outputs["spk_vecs"]),
                mesh.data_gather(outputs["accent_vecs"]), spk_table,
                model.accent_embeddings.weight)))
    return ld


def total_loss(loss_dict):
    return sum(v * w for v, w in loss_dict.values())


def create_train_state(model: TTSModel, device: str = "cuda",
                       **optimizer_kw) -> TrainState:
    """Step 0: the model (weights drawn from a seed or loaded) moved to
    ``device`` in train mode, and an optimizer over its parameters
    (``build_optimizer``'s keywords; RAdam, lr 1e-4, decay 1e-6, clip 1.0
    by default)."""
    model.to(resolve_device(device)).train()
    return TrainState(step=0, model=model,
                      optimizer=build_optimizer(model.parameters(),
                                                **optimizer_kw))


def _metrics(ld, loss) -> Dict[str, torch.Tensor]:
    """The loss terms and the loss, summed over the data group: the global
    batch's values, alike on every rank."""
    names = list(ld) + ["loss"]
    values = torch.stack([v.detach() for v, _ in ld.values()]
                         + [loss.detach()])
    return dict(zip(names, mesh.data_sum(values).unbind()))


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
        mesh.get_mesh().sync_grads(state.optimizer)
        grad_norm = state.optimizer.apply()
        metrics = _metrics(ld, loss)
        metrics["grad_norm"] = grad_norm
        return metrics

    return run


def step_inputs(featurizer, raw, noise_key) -> dict:
    """A featurizing step's inputs: the raw batch (``raw_arrays`` as
    tensors on the model's device) and the mel noise of ``noise_key``
    (absent where the featurizer adds none), drawn on the host's side of
    the step so a graph of it replays with each step's noise."""
    return featurizer.program_inputs(raw, noise_key)


def _tensors(batch) -> dict:
    """The batch's tensors: a graph's signature reads every leaf, and the
    loader's batches also carry the utterances' paths and text."""
    return {k: v for k, v in batch.items() if isinstance(v, torch.Tensor)}


def make_train_step(model: TTSModel, cfg: LossConfig, binarize: bool,
                    kl_on: bool, featurizer=None,
                    pool: Optional[GraphPool] = None) -> Callable:
    """One phase of the training step: ``step(state, inputs, generator)``
    -> (state, metrics), metrics 0-d tensors on the model's device (every
    loss term, 'loss' and 'grad_norm', the norm before the clip).
    ``inputs`` is a featurized batch or, with a ``featurizer``,
    ``step_inputs`` of a raw batch, featurized inside the step.

    With a ``pool`` the step runs through ``utils/graphs.Graphed`` in it,
    the counterpart of the JAX package's jitted step: on the card one CUDA
    graph per batch shape, RAdam branch and conv precision of this phase.
    A signature's first step runs eagerly (the warm-up), its second is
    captured and replayed, later ones replay: one launch a step. The host
    writes the optimizer's scalars (``prepare``) before each step and
    advances the step count after it; the dropout ``generator`` is
    registered with the graphs, so a replay draws the bits an eager step
    would. On the CPU the same code runs eagerly. Without a pool the step
    is eager everywhere (processes that talk over gloo, whose collectives
    a graph cannot hold)."""
    run = _device_step(model, cfg, binarize, kl_on)

    def device_step(state, inputs, generator):
        if featurizer is not None:
            # between the device marks train.featurize, in the step's
            # graph too (utils/profiling.device_span)
            raw = inputs["raw"]
            with device_span("train.featurize", raw["audio_i16"].device):
                inputs = featurizer.featurize_raw(raw, None,
                                                  noise=inputs.get("noise"))
        return run(state, inputs, generator)

    if pool is None:
        def train_step(state: TrainState, inputs, generator):
            state.optimizer.prepare()
            metrics = device_step(state, inputs, generator)
            state.step += 1
            return state, metrics

        return train_step

    # the graphs of the (state, generator) last stepped, which they read:
    # a new pair replaces them, and the pool takes back their memory
    current = {}

    def graphed_for(state, generator) -> Graphed:
        if current and current["state"] is state \
                and current["generator"] is generator:
            return current["fn"]

        def graphed(inputs):
            met = device_step(state, inputs, generator)
            return torch.stack(list(met.values())), list(met)

        fn = Graphed(graphed, pool, generators=[generator],
                     name="train_step")
        current.update(state=state, generator=generator, fn=fn)
        return fn

    def graphed_step(state: TrainState, inputs, generator):
        rectified = state.optimizer.prepare()
        if featurizer is None:
            inputs = _tensors(inputs)
        values, names = graphed_for(state, generator)(inputs,
                                                      key=(rectified,))
        state.step += 1
        return state, dict(zip(names, values.unbind()))

    return graphed_step


def make_train_megastep(model: TTSModel, cfg: LossConfig, featurizer,
                        binarize: bool, kl_on: bool,
                        pool: Optional[GraphPool] = None) -> Callable:
    """K featurize + train steps: ``megastep(state, stacked, generator)``
    -> (state, metrics), each metric stacked (K,), where ``stacked`` is
    ``stack_raw_batches`` of K raw batches as tensors on the model's
    device.

    The JAX package scans the K steps in one compiled program. Here step i
    featurizes ``stacked``'s row i with the mel noise of its global step
    (``featurizer.noise_key_for_step``) and trains on it, through the
    graphed step of ``make_train_step`` (one graph of one step replayed K
    times, rather than one of K steps: the host launches one graph a step
    either way, and a graph of K steps would hold K times the nodes).
    ``pool`` is the graphs' memory pool (a new one by default)."""
    step = make_train_step(model, cfg, binarize, kl_on, featurizer,
                           pool if pool is not None else GraphPool())

    def megastep(state: TrainState, stacked, generator: torch.Generator):
        rows = []
        for i in range(next(iter(stacked.values())).shape[0]):
            key = featurizer.noise_key_for_step(state.step)
            raw = {k: v[i] for k, v in stacked.items()}
            state, met = step(state, step_inputs(featurizer, raw, key),
                              generator)
            rows.append(met)
        values = torch.stack([torch.stack(list(m.values())) for m in rows],
                             dim=1)
        return state, dict(zip(rows[0], values.unbind()))

    return megastep


def make_val_step(model: TTSModel, cfg: LossConfig, binarize: bool = True,
                  pool: Optional[GraphPool] = None) -> Callable:
    """``val(state, batch)`` -> metrics, no dropout, no spectral-norm
    update, no gradients. With a ``pool``, through ``Graphed`` in it, as
    the JAX package jits it: on the card one CUDA graph per batch shape
    and conv precision, captured at its second batch and replayed after;
    eager on the CPU."""

    @torch.no_grad()
    def val_metrics(batch):
        outputs = model(batch, binarize=binarize, train=False)
        ld = compute_losses(model, cfg, outputs, batch,
                            binarization_on=binarize)
        return _metrics(ld, total_loss(ld))

    if pool is None:
        return lambda state, batch: val_metrics(batch)

    def graphed(batch):
        met = val_metrics(batch)
        return torch.stack(list(met.values())), list(met)

    fn = Graphed(graphed, pool, name="val_step")

    def val_step(state: TrainState, batch):
        values, names = fn(_tensors(batch), key=(binarize,))
        return dict(zip(names, values.unbind()))

    return val_step


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


def phase_flags(step: int, cfg: LossConfig):
    """(binarize, kl_on) for a global step."""
    return (step >= cfg.binarization_start_iter,
            step > cfg.kl_loss_start_iter)
