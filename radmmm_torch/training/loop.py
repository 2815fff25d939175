"""Trainer: fit / validate / predict / export, on one card or several.

Counterpart of ``radmmm_tpu/training/loop.py`` (the reference's
PyTorch-Lightning Trainer, the TTSModel LightningModule and its
sample-logging callbacks). One step function per phase (binarization,
KL), picked on the host; the whitening init runs on the first batch of a
fresh run; validation logs the losses, attention and mel images, the
quality scalars and Griffin-Lim audio when no vocoder checkpoint is
configured.

The JAX package jits its step, scans K featurize + train steps in one
compiled program (``megastep_k``) and jits its validation step. Here every
training step, whole group, partial or phase-straddling group and
``megastep_k`` 1 alike, runs through one graphed step
(``training/step.make_train_step`` with the trainer's ``GraphPool``): on
the card one CUDA graph per (batch shape, phase, RAdam branch, conv
precision), run eagerly at its first step (the warm-up), captured and
replayed at its second and replayed after, one launch a step; the
validation step likewise, per batch shape. On the CPU the same steps run
eagerly. The batches and their order are the JAX package's (the loader's
shape runs), each step keys its mel noise by its global step
(``Featurizer.noise_key_for_step``), and the bookkeeping is the same: a
whole group of K is logged, validated and saved once, after its last
step, a partial or phase-straddling group after each step. Where the
loader featurizes (``megastep_k`` 1, validation, the first batch,
``predict_reconstruction``), its calls replay the featurizer's graphs in a
pool of their own (``data/collate.Featurizer``; ``_graph_featurizer``),
from the loaders' threads while the steps replay theirs.

The validation samples, ``predict`` and ``predict_reconstruction`` go
through the same pool, as the JAX package jits ``tts_infer``,
``val_forward``, ``reconstruct``, ``predict_infer`` and the vocoder's
apply: ``model.infer`` at ``max_infer_frames``, the binarized eval
forward, ``model.reconstruct`` and the vocoder with its Denoiser
(``vocoder/utils.vocode_program``) each run through ``Graphed``, warmed up
at a signature's first call, captured at its second, replayed after. The
flow's latent (and a WaveGlow's noise) is drawn eagerly from the same
seeded generator the eager call draws it from, and passed in. Each 1x1's
inverse is refreshed eagerly before the samples, into storage the graphs
read (``ops/invertible``), so a validation after training steps replays
with the current weights' inverses. The host's reads of the results stay
outside the graphs; Griffin-Lim and the whitening init run eager.

Several cards: one process a card under torchrun (``training/cli.py
--distributed``), laid out on an (n_data, n_model) mesh
(``parallel/mesh.py``; ``n_data`` defaults to the world over ``n_model``).
Each process loads its own batch of ``batch_size`` (the global batch is
``batch_size`` x n_data, as in the JAX package's multi-process runs and
the reference's DDP), dealt in rounds of one shape by the loader; the
ranks of a model group take the batch of its first rank. The step is the
JAX step on the global batch (``training/step.py``). Rank 0 logs, writes
the code snapshot and the checkpoints (full, gathered); validation runs
each rank's dealt share and sums the metrics, and its images and audio
come from the first data rank. Over NCCL the graphs hold the step's
collectives, and every rank warms up, captures and replays at the same
steps (the loader deals rounds of one shape; the phase and the RAdam
branch follow the global step). gloo's collectives cannot be captured, so
over gloo the steps run eager.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from scipy.io import wavfile

from radmmm_torch.data.loader import DataLoader, prefetch_raw_groups
from radmmm_torch.models.tts import TTSConfig, TTSModel
from radmmm_torch.ops.conv import set_conv_precision
from radmmm_torch.parallel.mesh import (Mesh, assert_tp_layout, make_mesh,
                                        shard_state, use_mesh)
from radmmm_torch.training.step import (LossConfig, TrainState, _tensors,
                                        create_train_state, make_train_step,
                                        make_val_step, make_whitening_init,
                                        phase_flags, step_inputs)
from radmmm_torch.utils import profiling
from radmmm_torch.utils.checkpoint import (CheckpointManager,
                                           ENCODER_SUBMODULES, freeze_wrap,
                                           load_pretrained_submodules)
from radmmm_torch.utils.device import resolve_device
from radmmm_torch.utils.graphs import GraphPool, graph_program
from radmmm_torch.utils.logging import (TrainLogger, plot_alignment_to_numpy,
                                        plot_curves_to_numpy,
                                        plot_mel_to_numpy)
from radmmm_torch.utils.profiling import StepProfiler
from radmmm_torch.utils.quality import reconstruction_quality
from radmmm_torch.vocoder.utils import (GriffinLimVocoder, get_vocoder,
                                        load_hifigan_module, vocode_program)

# an exhausted iterator's item in Trainer._timed
_END = object()


@dataclasses.dataclass
class TrainerConfig:
    output_directory: str = "./output"
    max_steps: int = 1_000_000
    max_epochs: int = 10_000
    val_interval: int = 500
    iters_per_checkpoint: int = 3000
    log_interval: int = 10
    seed: int = 42
    learning_rate: float = 1e-4
    weight_decay: float = 1e-6
    optim_algo: str = "RAdam"
    grad_clip_val: Optional[float] = 1.0
    use_syncbnorm: bool = False
    n_data: Optional[int] = None
    n_model: int = 1
    griffin_lim_iters: int = 30
    decoder_path: Optional[str] = None
    encoders_path: Optional[str] = None
    vocoder_type: str = "hifigan"
    vocoder_config_path: Optional[str] = None
    vocoder_checkpoint_path: Optional[str] = None
    sampling_rate: int = 22050
    prediction_output_dir: Optional[str] = None
    predict_mode: str = "tts"
    sigma_infer: float = 0.8
    max_infer_frames: int = 1024
    hop_length: int = 256
    conv_precision: str = "f32"
    log_decoder_samples: bool = True
    val_prompts_path: Optional[str] = None
    max_to_keep: Optional[int] = None
    # a torch.profiler trace of profile_n_steps steps from
    # profile_start_step, written as a Chrome trace into profile_dir
    profile_dir: Optional[str] = None
    profile_start_step: int = 10
    profile_n_steps: int = 5
    detect_anomaly: bool = False
    save_code_snapshot: bool = True
    save_val_artifacts: bool = False
    # --ckpt_path: an integer step of this run, another run's directory
    # (its latest step), a ckpt directory, or a step directory like
    # <run>/ckpt/9000. None: the latest under output_directory/ckpt
    ckpt_path: Optional[str] = None
    megastep_k: int = 8
    device: str = "cuda"


def _np(x):
    """Tensors (nested in dicts) -> numpy arrays on the host."""
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


class Trainer:
    def __init__(self, tts_config: TTSConfig, loss_config: LossConfig,
                 trainer_config: TrainerConfig):
        self.tts_config = tts_config
        self.loss_cfg = loss_config
        self.cfg = trainer_config
        c = self.cfg
        # one process until fit lays the ranks out (n_data, n_model); the
        # batch norms and the whitening init read the global batch whatever
        # use_syncbnorm says, as in the JAX package (ROADMAP Queue 3)
        self.mesh = Mesh(1, 1)
        rank = dist.get_rank() if dist.is_initialized() else 0
        # process-wide, as in the JAX package: fit, validation, predict and
        # export (and every rank under --distributed) run at it
        set_conv_precision("bf16" if c.conv_precision == "bf16" else "f32")
        self.device = resolve_device(c.device)
        self.model: Optional[TTSModel] = None
        os.makedirs(c.output_directory, exist_ok=True)
        self.logger = TrainLogger(
            os.path.join(c.output_directory, "tb"),
            artifact_dir=(os.path.join(c.output_directory, "val_artifacts")
                          if c.save_val_artifacts else None),
            enabled=rank == 0)
        self.ckpt = CheckpointManager(
            os.path.join(c.output_directory, "ckpt"),
            max_to_keep=c.max_to_keep)
        self._step_cache: Dict[Any, Any] = {}
        # the memory pool of the graphed steps (on the card), kept with the
        # model
        self._graph_pool = GraphPool()
        # the pool of the loaders' featurize graphs (``_graph_featurizer``)
        self._feature_pool: Optional[GraphPool] = None
        self.frozen_prefixes = []
        if c.decoder_path:
            self.frozen_prefixes.append("decoder")
        if c.encoders_path:
            self.frozen_prefixes += self._encoder_modules()
        # the last fit's wall seconds, counts and step start times
        self.stats: Dict[str, Any] = {}

    def _encoder_modules(self):
        return [m for m in ENCODER_SUBMODULES
                if m != "accent_embeddings" or self.tts_config.use_accent]

    # ------------------------------------------------------------------
    def _resolve_ckpt(self):
        """cfg.ckpt_path -> (CheckpointManager, step or None)."""
        p = self.cfg.ckpt_path
        if p is None:
            return self.ckpt, None
        if isinstance(p, int) or (isinstance(p, str) and p.isdigit()):
            return self.ckpt, int(p)
        path = os.path.abspath(os.path.expanduser(str(p)))
        if os.path.isdir(os.path.join(path, "ckpt")):       # a run directory
            return CheckpointManager(os.path.join(path, "ckpt")), None
        base = os.path.basename(path.rstrip("/"))
        if base.isdigit():                                  # a step directory
            return CheckpointManager(os.path.dirname(path)), int(base)
        if not os.path.isdir(path):
            raise FileNotFoundError(f"ckpt_path {p!r} does not exist")
        return CheckpointManager(path), None                # a ckpt directory

    def _restore_state(self, state, require: bool = False):
        mgr, step = self._resolve_ckpt()
        state, restored = mgr.restore(state, step=step)
        if require and restored is None:
            raise FileNotFoundError(
                "no checkpoint found"
                + (f" at ckpt_path={self.cfg.ckpt_path!r}"
                   if self.cfg.ckpt_path is not None
                   else f" under {self.ckpt.directory} (pass --ckpt_path)"))
        return state, restored

    def _init_state(self, sample_batch) -> TrainState:
        """A fresh state on the trainer's device: the model drawn from the
        seed, the optimizer, pretrained submodules loaded and frozen. The
        port builds the model from its config alone; ``sample_batch`` is
        the JAX package's argument, kept so a test can start both trainers
        from one state."""
        c = self.cfg
        torch.manual_seed(c.seed)
        model = TTSModel(self.tts_config)
        state = create_train_state(
            model, device=self.device, optim_algo=c.optim_algo,
            learning_rate=c.learning_rate, weight_decay=c.weight_decay,
            grad_clip_val=c.grad_clip_val)
        if c.decoder_path:
            load_pretrained_submodules(model, c.decoder_path, ["decoder"])
        if c.encoders_path:
            load_pretrained_submodules(model, c.encoders_path,
                                       self._encoder_modules())
        freeze_wrap(state.optimizer, model, self.frozen_prefixes)
        self.model = model
        self._step_cache.clear()
        self._graph_pool = GraphPool()
        return state

    def _step_pool(self) -> Optional[GraphPool]:
        """The pool of the graphed training and validation steps; None
        where they run eager: over gloo, whose collectives a CUDA graph
        cannot hold."""
        return self._graph_pool if self.mesh.capturable else None

    def _featurizer_pool(self) -> Optional[GraphPool]:
        """A new pool for the graphs of the loaders' featurize calls, apart
        from the steps' pool: the loaders' threads replay them while the
        steps replay theirs. None where they run eager."""
        return GraphPool()

    def _graph_featurizer(self, dm) -> None:
        """The loaders' featurize calls (``dm.featurizer``, from the
        loaders' threads and ``first_batch``) replay their graphs in
        ``_featurizer_pool()`` from now."""
        if getattr(dm, "featurizer", None) is not None:
            self._feature_pool = self._featurizer_pool()
            dm.featurizer.use_pool(self._feature_pool)

    def _train_step_fn(self, binarize: bool, kl_on: bool, featurizer=None):
        """The training step of one phase, over a featurized batch or,
        with ``featurizer``, featurizing a raw one."""
        key = (binarize, kl_on, featurizer)
        if key not in self._step_cache:
            self._step_cache[key] = make_train_step(
                self.model, self.loss_cfg, binarize, kl_on, featurizer,
                pool=self._step_pool())
        return self._step_cache[key]

    def _program(self, name: str, fn):
        """``fn`` (a dict of tensors -> a tree of tensors) through
        ``Graphed`` in the steps' pool, called as ``program(inputs,
        key=())``; eager where the steps are (``_step_pool`` None)."""
        if name not in self._step_cache:
            self._step_cache[name] = graph_program(
                torch.no_grad()(fn), self._step_pool(), name)
        return self._step_cache[name]

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _dropout_generator(self) -> torch.Generator:
        """The training steps' dropout stream: one a data rank (the ranks of
        a model group draw alike, as their replicated work must)."""
        return self._generator(self.cfg.seed + 1
                               + 1_000_003 * self.mesh.data_index)

    # ------------------------------------------------------------------
    def save_current_code(self):
        """Tar the framework's sources into the run directory
        (utils.py:44-51)."""
        import tarfile
        root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        out = os.path.join(self.cfg.output_directory, "code_snapshot.tar.gz")
        with tarfile.open(out, "w:gz") as tar:
            for dirpath, dirnames, filenames in os.walk(root):
                dirnames[:] = [d for d in dirnames
                               if d not in (".git", "output", "build",
                                            "__pycache__")]
                for fn in filenames:
                    if fn.endswith((".py", ".cu", ".cuh", ".yaml")):
                        full = os.path.join(dirpath, fn)
                        tar.add(full, arcname=os.path.relpath(full, root))
        print(f"saved code snapshot to {out}")

    def fit(self, dm, resume: bool = True):
        self.mesh = m = make_mesh(self.cfg.n_data, self.cfg.n_model)
        dm.setup("fit")
        if self.cfg.save_code_snapshot and m.rank == 0:
            self.save_current_code()
        if m.n_data * m.n_model > 1:
            print(f"training over mesh {m.shape} (rank {m.rank}, "
                  f"{self.device})")
        with use_mesh(m):
            return self._fit_loop(dm, resume)

    def _fit_loop(self, dm, resume: bool):
        c = self.cfg
        self._graph_featurizer(dm)
        train_loader = dm.train_dataloader()
        t0 = time.perf_counter()
        first_batch = self.mesh.broadcast_batch(train_loader.first_batch())
        first_batch_s = time.perf_counter() - t0
        state = self._init_state(first_batch)

        start_step = 0
        restored = None
        t0 = time.perf_counter()
        if resume:
            state, restored = self._restore_state(state)
            if restored is not None:
                start_step = int(restored)
                print(f"resumed from step {start_step}")
                dm.featurizer.set_noise_base(start_step)
        if shard_state(state, self.mesh):
            assert_tp_layout(self.model, self.mesh)
        if restored is None:
            make_whitening_init(self.model)(state, first_batch)
            print("initialized whitening conv from first batch")

        val_step = make_val_step(self.model, self.loss_cfg,
                                 pool=self._step_pool())
        gen = self._dropout_generator()
        m = self.mesh
        if not m.capturable and m.rank == 0:
            print(f"training and validation steps run eager over "
                  f"{m.n_data * m.n_model} processes: gloo's collectives "
                  "cannot be captured in a CUDA graph (NCCL's can)")
        # step_starts and noise_keys: one entry a step (the key is None
        # where the loader featurizes); graphed_steps: steps that replayed
        # a graph; pause_s: validation and checkpoint seconds after a
        # step, by step
        self.stats = dict(steps=0, megastep_steps=0, graphed_steps=0,
                          loader_wait_s=0.0, val_s=0.0,
                          ckpt_save_s=0.0, ckpt_bytes=0, ckpt_saves=0,
                          step_starts=[], noise_keys=[], pause_s={},
                          first_batch_s=first_batch_s,
                          restore_s=(time.perf_counter() - t0
                                     if restored is not None else 0.0))
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t_fit = time.perf_counter()
        t_last = time.perf_counter()
        last_logged = start_step
        self._profiler = StepProfiler(
            c.profile_dir if self.mesh.rank == 0 else None,
            c.profile_start_step, c.profile_n_steps, self.device)

        def paused(step, t0) -> float:
            dt = time.perf_counter() - t0
            pauses = self.stats["pause_s"]
            pauses[step] = pauses.get(step, 0.0) + dt
            return dt

        def save(step):
            t0 = time.perf_counter()
            self.stats["ckpt_bytes"] = self.ckpt.save(
                step, state, exclude_prefixes=self.frozen_prefixes)
            self.stats["ckpt_save_s"] += paused(step, t0)
            self.stats["ckpt_saves"] += 1

        def post_step(metrics, prev_step, step) -> bool:
            """Logging, validation, checkpoints and the stop, shared by
            both loops: an interval counts when the step crosses one of its
            multiples, so a group of K steps hits each interval once."""
            nonlocal t_last, last_logged

            def crossed(interval):
                return prev_step // interval != step // interval

            if c.detect_anomaly:
                bad = [m for m in metrics
                       if not np.isfinite(m["loss"].item())]
                if bad:
                    raise FloatingPointError(
                        f"non-finite loss at step {step}: "
                        f"{ {k: v.item() for k, v in bad[0].items()} }")
            if crossed(c.log_interval):
                m = {k: v.item() for k, v in metrics[-1].items()}
                dt = time.perf_counter() - t_last
                m["steps_per_sec"] = (step - last_logged) / dt
                t_last = time.perf_counter()
                last_logged = step
                self.logger.scalars("train", m, step)
                print(f"step {step}: loss={m['loss']:.4f} "
                      f"mel={m.get('loss_mel', 0):.4f} "
                      f"({m['steps_per_sec']:.2f} it/s)")
            if crossed(c.val_interval) and dm.valset:
                t0 = time.perf_counter()
                self.validate(state, dm, val_step, step)
                self.stats["val_s"] += paused(step, t0)
            done = step >= c.max_steps
            if crossed(c.iters_per_checkpoint) or done:
                save(step)
            return done

        try:
            if self._megastep_k(dm) > 1:
                self._fit_loop_mega(dm, state, gen, start_step, post_step)
            else:
                self._fit_loop_plain(train_loader, state, gen, start_step,
                                     post_step)
        finally:
            self._profiler.stop()
        s = self.stats
        s["train_s"] = (time.perf_counter() - t_fit - s["val_s"]
                        - s["ckpt_save_s"])
        pool = self._graph_pool
        s["warmups"], s["captures"] = pool.warmups, len(pool.captures)
        s["replays"] = pool.replays
        s["graph_pool_bytes"] = sum(c.pool_bytes for c in pool.captures)
        # the loaders' featurize graphs, first batch and validation in
        feat = self._feature_pool or GraphPool()
        s["featurize_warmups"] = feat.warmups
        s["featurize_captures"] = len(feat.captures)
        s["featurize_replays"] = feat.replays
        s["featurize_pool_bytes"] = sum(c.pool_bytes for c in feat.captures)
        s["peak_reserved_bytes"] = (
            torch.cuda.max_memory_reserved(self.device)
            if self.device.type == "cuda" else 0)
        if s["steps"]:
            print(f"fit: {s['steps']} steps, "
                  f"{1e3 * s['train_s'] / s['steps']:.2f} ms a step, "
                  f"{100 * s['loader_wait_s'] / max(s['train_s'], 1e-9):.1f}"
                  f"% of it waiting on the loader; validation "
                  f"{s['val_s']:.2f} s, checkpoints {s['ckpt_save_s']:.2f} s;"
                  f" {s['megastep_steps']} steps in whole groups, "
                  f"{s['graphed_steps']} replayed a graph (graph warm-ups "
                  f"{s['warmups']}, captures {s['captures']}, replays "
                  f"{s['replays']}, pool "
                  f"{s['graph_pool_bytes'] / 2**20:.1f} MiB; the loaders' "
                  f"featurize: warm-ups {s['featurize_warmups']}, captures "
                  f"{s['featurize_captures']}, replays "
                  f"{s['featurize_replays']}, pool "
                  f"{s['featurize_pool_bytes'] / 2**20:.1f} MiB); peak "
                  f"reserved {s['peak_reserved_bytes'] / 2**20:.1f} MiB")
        return state

    def _megastep_k(self, dm) -> int:
        """K same-shape batches a group whenever the data module has a
        featurizer; 1 (a batch at a time) otherwise."""
        k = int(self.cfg.megastep_k)
        if k <= 1 or getattr(dm, "featurizer", None) is None:
            return 1
        return k

    def _before_step(self, step: int, noise_key=None):
        """The host's bookkeeping before a training step: its start time,
        its batch's mel-noise key (None where the loader featurizes) and
        the profiled window."""
        self.stats["step_starts"].append(time.perf_counter())
        self.stats["noise_keys"].append(noise_key)
        self._profiler.before(step)

    def _after_step(self, step: int):
        self._profiler.after(step)
        self.stats.update(self._profiler.stats)
        self.stats["steps"] += 1

    def _run_step(self, state, batch, step: int, gen, featurizer=None):
        """One training step of the phase of ``step`` through its graphed
        step, inside the profiled window when one is configured. With
        ``featurizer``, ``batch`` is a raw batch, featurized in the step
        with the mel noise of its step's key (recorded in the stats)."""
        key = (None if featurizer is None
               else featurizer.noise_key_for_step(step))
        self._before_step(step, key)
        with profiling.span("train.inputs"):
            # the model group's batch, outside the graph
            batch = self.mesh.broadcast_batch(batch)
            if featurizer is not None:
                batch = step_inputs(featurizer, batch, key)
        replays = self._graph_pool.replays
        with profiling.span("train.step"):
            state, metrics = self._train_step_fn(
                *phase_flags(step, self.loss_cfg), featurizer)(state, batch,
                                                               gen)
        if self._graph_pool.replays > replays:
            self.stats["graphed_steps"] += 1
        self._after_step(step)
        return state, metrics

    def _timed(self, it):
        """Iterate ``it``, adding the time spent waiting on it (span
        ``train.loader_wait``) to the loader's share."""
        it = iter(it)
        while True:
            with profiling.timed("train.loader_wait") as wait:
                item = next(it, _END)
            if item is _END:
                return
            self.stats["loader_wait_s"] += wait.seconds
            yield item

    def _fit_loop_plain(self, loader, state, gen, step, post_step):
        for _ in range(self.cfg.max_epochs):
            for batch in self._timed(loader):
                state, metrics = self._run_step(state, batch, step, gen)
                step += 1
                if post_step([metrics], step - 1, step):
                    return

    def _fit_loop_mega(self, dm, state, gen, step, post_step):
        """Groups of up to K same-shape raw batches (the loader's shape
        runs), uploaded ahead by a thread. Every step featurizes its row
        and trains on it through the graphed step. A whole group (K
        batches, one phase, inside max_steps) is then logged, validated
        and saved once, after its last step, as in the JAX package's
        megastep; a partial or phase-straddling group after each step, as
        in its per-batch fallback."""
        c, k, feat = self.cfg, self._megastep_k(dm), dm.featurizer
        loader = DataLoader(dm.trainset, dm.batch_size, shuffle=True,
                            featurizer=None, num_threads=dm.num_threads,
                            prefetch=max(2, k), seed=dm.seed,
                            hop_length=feat.hop_length, shape_runs=k)
        for _ in range(c.max_epochs):
            for stacked in self._timed(prefetch_raw_groups(
                    loader, feat, k, self.device)):
                n = next(iter(stacked.values())).shape[0]
                whole = (n == k
                         and phase_flags(step, self.loss_cfg)
                         == phase_flags(step + k - 1, self.loss_cfg)
                         and step + k <= c.max_steps)
                group, prev = [], step
                for i in range(n):
                    raw = {key: v[i] for key, v in stacked.items()}
                    state, metrics = self._run_step(state, raw, step, gen,
                                                    feat)
                    step += 1
                    group.append(metrics)
                    if not whole and post_step(group[-1:], step - 1, step):
                        return
                if whole:
                    self.stats["megastep_steps"] += n
                    if post_step(group, prev, step):
                        return

    # ------------------------------------------------------------------
    def validate(self, state: TrainState, dm, val_step, step: int):
        """The validation set's losses (each rank its dealt share, the
        metrics summed over the data group by the step), read from the
        card once, then the samples of the first data rank's model group
        (rank 0 logs them)."""
        rows, names, first = [], None, None
        for batch in dm.val_dataloader():
            batch = self.mesh.broadcast_batch(batch)
            met = val_step(state, batch)
            names = list(met)
            rows.append(torch.stack(list(met.values())))
            if first is None:
                first = batch
        if rows:
            host = _np(torch.stack(rows))
            self.logger.scalars("val", {
                k: float(np.mean(host[:, j].tolist()))
                for j, k in enumerate(names)}, step)
        if self.mesh.data_index == 0:
            if first is not None and self.cfg.log_decoder_samples:
                self._log_val_samples(state, first, step)
            if self.cfg.val_prompts_path:
                self._log_tts_samples(state, dm, step)
        self.logger.flush()

    # the model's keys of infer's optional speaker ids, by batch key
    _INFER_IDS = (("decoder_spk_id", "decoder_speaker_ids"),
                  ("f0_spk_id", "f0_speaker_ids"),
                  ("energy_spk_id", "energy_speaker_ids"),
                  ("duration_spk_id", "duration_speaker_ids"))

    def _infer(self, b: dict, generator: torch.Generator) -> dict:
        """``model.infer`` of the batch ``b`` (``_predict_batch``'s keys;
        the optional speaker ids default to ``spk_id``) at
        ``max_infer_frames`` through its graph, the flow's latent drawn
        eagerly from ``generator``, as infer draws it: -> {'mel', 'lens'
        (the lengths)}."""
        # the programs hold the model, not the trainer that holds them
        c, model, ids = self.cfg, self.model, self._INFER_IDS

        def infer(x):
            out = model.infer(
                x["text"], x["text_lens"], x["spk_id"],
                accent_ids=x["accent_id"], f0_mean=x["speaker_f0_mean"],
                f0_std=x["speaker_f0_std"], sigma=c.sigma_infer,
                max_frames=c.max_infer_frames, residual=x["residual"],
                **{kw: x[k] for k, kw in ids if k in x})
            return {"mel": out["mel"], "lens": out["lens"].lengths}

        residual = model.decoder.draw_residual(
            b["text"].shape[0], c.max_infer_frames, c.sigma_infer, generator,
            self.device)
        return self._program("tts_infer", infer)(
            dict(b, residual=residual),
            key=(model.training, c.max_infer_frames))

    # what reconstruct reads of a featurized batch
    _RECONSTRUCT_KEYS = ("text", "input_lengths", "mel", "output_lengths",
                         "speaker_ids", "accent_ids", "attn_prior", "f0",
                         "energy_avg")

    def _reconstruct(self, batch, generator: torch.Generator) -> dict:
        """``model.reconstruct`` of a featurized batch through its graph,
        the latent drawn eagerly from ``generator`` at sigma 1: -> {'mel',
        'lens' (the lengths)}."""
        model = self.model

        def reconstruct(x):
            out = model.reconstruct(x, residual=x["residual"])
            return {"mel": out["mel"], "lens": out["lens"].lengths}

        x = {k: batch[k] for k in self._RECONSTRUCT_KEYS if k in batch}
        x["residual"] = model.decoder.draw_residual(
            x["mel"].shape[0], x["mel"].shape[1], 1.0, generator,
            x["mel"].device)
        return self._program("reconstruct", reconstruct)(
            x, key=(model.training,))

    def _val_forward(self, batch) -> dict:
        """The binarized eval forward of a batch through its graph: the
        hard and soft attention and the predictors' {x_hat, x}."""
        model = self.model

        def forward(x):
            out = model(x, binarize=True, train=False)
            keep = {k: v for k, v in out.items() if isinstance(v, dict)}
            keep.update(attn=out["attn"], attn_soft=out["attn_soft"])
            return keep

        return self._program("val_forward", forward)(
            _tensors(batch), key=(model.training,))

    @torch.no_grad()
    def _log_tts_samples(self, state: TrainState, dm, step: int,
                         max_prompts: int = 4):
        """Synthesize the fixed prompts end to end and log their audio."""
        from radmmm_torch.data.dataset import TextOnlyData
        if not hasattr(self, "_tts_prompts"):
            tod = TextOnlyData(self.cfg.val_prompts_path, dm.tp,
                               dm.trainset.speaker_ids,
                               dm.trainset.accent_ids)
            self._tts_prompts = [tod[i]
                                 for i in range(min(len(tod), max_prompts))]
        items = self._tts_prompts
        if not items or self.model.duration_predictor is None:
            return
        # the current weights' inverses, where the graphs read them
        self.model.cache_inverses()
        b = self._predict_batch(items)
        out = self._infer({k: b[k] for k in (
            "text", "text_lens", "spk_id", "accent_id", "speaker_f0_mean",
            "speaker_f0_std")}, self._generator(self.cfg.seed))
        audio = _np(self._vocode(out["mel"]))
        lens = _np(out["lens"])
        mel = _np(out["mel"])
        for i in range(len(items)):
            self.logger.audio(f"val/tts_sample_{i}",
                              audio[i][: lens[i] * self.cfg.hop_length],
                              step, self.cfg.sampling_rate)
            self.logger.image(f"val/tts_mel_{i}",
                              plot_mel_to_numpy(mel[i, :lens[i]]), step)

    @torch.no_grad()
    def _log_val_samples(self, state: TrainState, batch, step: int):
        """Attention images, reconstruction audio and the quality scalars
        (LogDecoderSamplesCallback, training_callbacks.py:36-210)."""
        self.model.cache_inverses()
        outputs = self._val_forward(batch)
        attn = _np(outputs["attn"][0])
        attn_soft = _np(outputs["attn_soft"][0])
        in_len = int(batch["input_lengths"][0])
        out_len = int(batch["output_lengths"][0])
        self.logger.image("val/attention_hard", plot_alignment_to_numpy(
            attn[:out_len, :in_len]), step)
        self.logger.image("val/attention_soft", plot_alignment_to_numpy(
            attn_soft[:out_len, :in_len]), step)
        self.logger.image("val/mel_gt", plot_mel_to_numpy(
            _np(batch["mel"][0, :out_len])), step)
        curves = {}
        for key, name in (("f0_outputs", "f0"),
                          ("energy_outputs", "energy"),
                          ("voiced_outputs", "voiced")):
            if key in outputs:
                gt = _np(outputs[key]["x"][0, :out_len, 0])
                pred = _np(outputs[key]["x_hat"][0, :out_len, 0])
                if name == "voiced":          # logits -> probability
                    pred = 1.0 / (1.0 + np.exp(-pred))
                curves[f"{name}_gt"] = gt
                curves[f"{name}_pred"] = pred
        if curves:
            self.logger.image("val/attributes",
                              plot_curves_to_numpy(curves), step)
        rec = self._reconstruct(batch, self._generator(0))
        self.logger.image("val/mel_reconstructed", plot_mel_to_numpy(
            _np(rec["mel"][0, :out_len])), step)
        # MCD of the flow reconstruction, F0 RMSE and voicing F1 over the
        # batch: a broken flow inverse or predictor moves these by orders
        # of magnitude where the loss curves barely move
        host = {k: _np(v) for k, v in batch.items()
                if isinstance(v, torch.Tensor)}
        self.logger.scalars("val", reconstruction_quality(
            host, _np(rec["mel"]), _np({k: v for k, v in outputs.items()
                                        if isinstance(v, dict)})), step)
        audio = self._vocode(rec["mel"][:1])
        if audio is not None:
            self.logger.audio("val/reconstruction", _np(audio)[0], step,
                              self.cfg.sampling_rate)

    # ------------------------------------------------------------------
    def _vocode(self, mels):
        """Mels -> audio: the configured vocoder with its Denoiser through
        its graph (``vocode_program`` in the steps' pool), or Griffin-Lim,
        eager, from a generator seeded 0."""
        if not hasattr(self, "_vocoder"):
            voc_fn, denoiser = get_vocoder(
                self.cfg.vocoder_type, self.cfg.vocoder_config_path,
                self.cfg.vocoder_checkpoint_path, device=self.device)
            if voc_fn is None:
                print("no vocoder checkpoint configured — validation audio "
                      f"uses griffin-lim ({self.cfg.griffin_lim_iters} "
                      "iters; set trainer.griffin_lim_iters / "
                      "vocoder_checkpoint_path)")
                voc_fn = GriffinLimVocoder(
                    sampling_rate=self.cfg.sampling_rate,
                    hop_length=self.cfg.hop_length,
                    n_mel_channels=self.tts_config.n_mel_channels,
                    n_iters=self.cfg.griffin_lim_iters)
            self._vocoder = (voc_fn, denoiser)
        voc_fn, denoiser = self._vocoder
        if isinstance(voc_fn, GriffinLimVocoder):
            return voc_fn(mels, generator=self._generator(0))
        key = ("vocode", voc_fn)
        if key not in self._step_cache:
            self._step_cache[key] = vocode_program(
                self.cfg.vocoder_type, voc_fn, denoiser, self._step_pool())
        return self._step_cache[key](mels)

    def _write_wav(self, path: str, wav: np.ndarray) -> None:
        wavfile.write(path, self.cfg.sampling_rate,
                      (np.clip(wav, -1, 1) * 32767).astype(np.int16))

    def _restored_for_inference(self, state: Optional[TrainState]):
        if state is None:
            state = self._init_state(None)
            state, _ = self._restore_state(state, require=True)
        self.model.eval().cache_inverses()
        return state

    def predict(self, dm, state: Optional[TrainState] = None):
        """TTS (or reconstruction) prediction -> wav files
        (tts_lightning_modules.py:585-606)."""
        if self.cfg.predict_mode == "reconstruction":
            return self.predict_reconstruction(dm, state)
        dm.setup("predict")
        out_dir = (self.cfg.prediction_output_dir
                   or os.path.join(self.cfg.output_directory, "predictions"))
        os.makedirs(out_dir, exist_ok=True)
        state = self._restored_for_inference(state)
        items = list(dm.predict_items())
        with torch.no_grad():
            out = self._infer(self._predict_batch(items),
                              self._generator(self.cfg.seed))
            audio = _np(self._vocode(out["mel"]))
        lens = _np(out["lens"])
        self.predicted_frames = lens.tolist()
        paths = []
        for i, item in enumerate(items):
            path = os.path.join(out_dir, f"output_sample_{item['idx']}_"
                                f"{self.cfg.predict_mode}.wav")
            self._write_wav(path, audio[i][: lens[i] * self.cfg.hop_length])
            paths.append(path)
        print(f"predictions saved to {out_dir}")
        return paths

    def predict_reconstruction(self, dm, state: Optional[TrainState] = None):
        """Analysis-synthesis and voice cloning: each utterance's mel
        rebuilt from its own attributes and MAS durations, then vocoded
        (reconstruct_from_batch_attributes, tts_lightning_modules.py:
        389-437). Voice cloning: change the speaker column of the
        filelist."""
        dm.setup("fit")
        out_dir = (self.cfg.prediction_output_dir
                   or os.path.join(self.cfg.output_directory, "predictions"))
        os.makedirs(out_dir, exist_ok=True)
        self._graph_featurizer(dm)
        loader = dm.train_dataloader()
        if state is None:
            # the JAX package draws a first batch to build its state: the
            # same draws here, so each utterance meets its augmentation
            loader.first_batch()
        state = self._restored_for_inference(state)
        hop = self.cfg.hop_length
        paths = []
        for batch in loader:
            with torch.no_grad():
                rec = self._reconstruct(batch,
                                        self._generator(self.cfg.seed))
                audio = _np(self._vocode(rec["mel"]))
            lens = _np(rec["lens"])
            idx = _np(batch["idx"])
            for i in range(len(lens)):
                path = os.path.join(out_dir, f"output_sample_{int(idx[i])}_"
                                    "reconstruction.wav")
                self._write_wav(path, audio[i][: lens[i] * hop])
                paths.append(path)
        print(f"predictions saved to {out_dir}")
        return paths

    def _predict_batch(self, items):
        B = len(items)
        T = max(len(x["text_encoded"]) for x in items)
        text = np.zeros((B, T), np.int32)
        for i, x in enumerate(items):
            text[i, :len(x["text_encoded"])] = x["text_encoded"]

        def arr(key, dtype=np.int32):
            return np.array([x[key] for x in items], dtype)

        host = {
            "text": text,
            "text_lens": np.array([len(x["text_encoded"]) for x in items],
                                  np.int32),
            "spk_id": arr("spk_id"),
            "decoder_spk_id": arr("decoder_spk_id"),
            "duration_spk_id": arr("duration_spk_id"),
            "f0_spk_id": arr("f0_spk_id"),
            "energy_spk_id": arr("energy_spk_id"),
            "accent_id": arr("accent_id"),
            "speaker_f0_mean": arr("speaker_f0_mean", np.float32),
            "speaker_f0_std": arr("speaker_f0_std", np.float32),
        }
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in host.items()}

    def export(self, path: str, batch_size: int = 8, max_text: int = 96,
               use_vocoder: bool = True, buckets=None, frame_buckets=None,
               state: Optional[TrainState] = None) -> int:
        """Write the trained TTS function as a serving artifact
        (``serving.export_tts``, loaded by ``serving.load_tts``). Needs a
        checkpoint unless a live state is given. A configured HiFi-GAN
        checkpoint file (an upstream ``g_*``) is baked in; as in the JAX
        package, a ``vocoder-fit`` run directory cannot be."""
        from radmmm_torch.serving import export_tts
        vocoder = None
        if (use_vocoder and self.cfg.vocoder_type == "hifigan"
                and self.cfg.vocoder_checkpoint_path
                and os.path.exists(str(self.cfg.vocoder_checkpoint_path))):
            vocoder = load_hifigan_module(self.cfg.vocoder_config_path,
                                          self.cfg.vocoder_checkpoint_path)
        self._restored_for_inference(state)
        n = export_tts(self.model, path, batch_size=batch_size,
                       max_text=max_text, sigma=self.cfg.sigma_infer,
                       max_frames=self.cfg.max_infer_frames,
                       vocoder=vocoder, buckets=buckets,
                       frame_buckets=frame_buckets)
        kind = "audio" if vocoder is not None else "mel"
        what = f"{len(buckets)}-bucket {kind}" if buckets else kind
        if frame_buckets:
            what += f", two-stage x{len(frame_buckets)} frame buckets"
        print(f"exported {what} TTS artifact ({n / 1e6:.1f} MB) to {path}")
        return n
