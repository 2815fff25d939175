"""The port's CUDA graphs on the card (``radmmm_torch/utils/graphs.py``),
against the eager calls they replay, at the tests' tiny widths.

A CUDA graph has no CPU mode, so these tests carry the ``cuda`` marker
and skip without a card. The file imports torch and the port only, and
nothing from ``tests/`` (a namespace package, which an installed package
named ``tests`` shadows), so it runs where JAX is not installed:

    python -m pytest tests/test_torch_graphs_cuda.py -m cuda --noconftest

Everything is held bit for bit: a replay runs the kernels the eager call
runs, on the same inputs, in the same order; cuDNN is held to its
deterministic algorithms, since its default f32 ones sum in an order
that changes from run to run (``chip_smoke.py``'s graphs phase measured
it at full width). The served PCM of the card against the CPU: within 1
LSB (f32 waveforms that differ in the last bits round to neighbouring
codes)."""
import collections
import gc
import threading

import numpy as np
import pytest
import torch

from radmmm_torch.data import collate
from radmmm_torch.models.tts import TTSConfig, TTSModel
from radmmm_torch.serving import export_tts, load_tts
from radmmm_torch.training import step
from radmmm_torch.utils import graphs
from radmmm_torch.utils.launches import launch_counts
from radmmm_torch.vocoder.hifigan import Generator, HiFiGANConfig

pytestmark = pytest.mark.cuda

K = 3
SR = 22050
FEAT = dict(filter_length=256, hop_length=64, win_length=256,
            n_mel_channels=8, f0_min=120.0, f0_max=500.0,
            mel_noise_scale=0.05)
OPT = dict(learning_rate=1e-3, weight_decay=1e-2, grad_clip_val=1.0)
LOSS = dict(cross_covariance_weight=1.0,
            speaker_reg={"variance": 1.0, "covariance": 1.0},
            accent_reg={"variance": 0.5, "covariance": 0.5})
TEXT_BUCKETS = [(1, 8), (4, 12)]
FRAME_BUCKETS = (16, 48)


def tiny_config() -> TTSConfig:
    """The tests' tiny model (tests/test_tts_model.py's), as the port's
    config."""
    dap = dict(n_speaker_dim=4, n_accent_dim=2, use_accent_embedding=True,
               in_dim=18, out_dim=1, reduction_factor=2,
               n_backbone_layers=1, n_hidden=8, kernel_size=3,
               p_dropout=0.25, lstm_type="bilstm")
    return TTSConfig(
        n_text_tokens=30, n_text_dim=16, n_speakers=3, n_speaker_dim=4,
        n_augmentations=0, use_accent=True, n_accents=2, n_accent_dim=2,
        n_mel_channels=8, use_accent_emb_for_encoder=True,
        use_speaker_emb_for_alignment=True, lstm_norm_fn="spectral",
        decoder=dict(n_speaker_dim=4, use_accent=True, n_accent_dim=2,
                     n_text_dim=18, use_context_lstm=True, n_f0_dims=1,
                     n_energy_avg_dims=1, n_mel_channels=8, n_flows=2,
                     n_conv_layers_per_step=1, n_early_size=2,
                     n_early_every=2, n_group_size=2,
                     affine_model="wavenet", scaling_fn="tanh",
                     use_partial_padding=True),
        f0_predictor=dict(dap, target_offset=-5.0),
        energy_predictor=dict(dap, target_offset=-0.75),
        voiced_predictor=dict(dap), duration_predictor=dict(dap,
                                                            log_target=True))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = old


def _stacked(dev):
    """K raw batches of two voiced utterances (0.19 and 0.16 s), each
    step's tones and text its own, stacked on ``dev``."""
    rng = np.random.default_rng(5)
    feat = collate.Featurizer(device="cpu", **FEAT)
    raws = []
    for k in range(K):
        items = []
        for b, sec in enumerate((0.19, 0.16)):
            t = np.arange(int(sec * SR)) / SR
            f = 150.0 + 30 * b + 10 * k
            audio = (0.5 * np.sin(2 * np.pi * f * t)
                     + 0.003 * rng.standard_normal(t.size))
            items.append({
                "audio": audio.astype(np.float32),
                "text_encoded": rng.integers(1, 30, 7 - b),
                "speaker_id": b, "accent_id": b % 2,
                "speaker_f0_mean": 5.0, "speaker_f0_std": 0.3,
                "speaker_energy_mean": 0.5, "speaker_energy_std": 0.15,
                "audiopath": f"u{b}.wav", "text_raw": "x",
                "language": "en_US", "idx": b})
        raws.append(feat.raw_arrays(collate.collate_host(
            items, hop_length=64, audio_frames_multiple=16)))
    return {k: torch.from_numpy(a).to(dev)
            for k, a in step.stack_raw_batches(raws).items()}


def _models(n: int):
    out = []
    for _ in range(n):
        torch.manual_seed(0)
        out.append(TTSModel(tiny_config()))
    return out


@pytest.mark.parametrize("phase", [(False, False), (True, True)])
def test_graphed_megastep_equals_eager_steps(card, phase):
    """3 x K steps: metrics, parameters and the dropout generator bit for
    bit with eager steps, and the ledger counts the launches the eager
    steps make. RAdam's plain branch (steps 1-5) and rectified one (from
    step 6) each warm up at their first step and capture at their
    second; the rest replay."""
    stacked = _stacked(card)
    g_model, e_model = _models(2)
    feat = collate.Featurizer(device=card, **FEAT)
    loss = step.LossConfig(**LOSS)
    gstate = step.create_train_state(g_model, device=card, **OPT)
    ggen = torch.Generator(device=card).manual_seed(1)
    pool = graphs.GraphPool()
    mega = step.make_train_megastep(g_model, loss, feat, *phase, pool=pool)
    estate = step.create_train_state(e_model, device=card, **OPT)
    egen = torch.Generator(device=card).manual_seed(1)
    fn = step.make_train_step(e_model, loss, *phase)
    launch_counts.clear()
    gmet = [mega(gstate, stacked, ggen)[1] for _ in range(3)]
    launched = dict(launch_counts)
    launch_counts.clear()
    emet = []
    for _ in range(3):
        for i in range(K):
            raw = {k: v[i] for k, v in stacked.items()}
            batch = feat.featurize_raw(raw,
                                       feat.noise_key_for_step(estate.step))
            estate, m = fn(estate, batch, egen)
            emet.append(m)
    assert launched == dict(launch_counts)
    assert pool.warmups == len(pool.captures) == 2
    assert pool.replays == 3 * K - 2
    for name in emet[0]:
        got = torch.cat([m[name] for m in gmet])
        assert torch.equal(got, torch.stack([m[name] for m in emet])), name
    for a, b in zip(g_model.parameters(), e_model.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(ggen.get_state(), egen.get_state())
    assert gstate.optimizer.count == estate.optimizer.count == 3 * K


def test_partial_and_straddling_groups_graphed_equal_eager_steps(card):
    """The trainer's steps outside whole groups: a whole group of K at
    one shape, then a partial group of K - 1 at the same shape that
    straddles the binarization switch (its first step plain, the rest
    binarized with KL on), each step through its phase's graphed step
    (one pool, as the trainer keeps it) against eager steps: metrics,
    parameters and the generator bit for bit, the launches counted
    alike. Each (phase, RAdam branch) warms up at its first step and
    captures at its second."""
    stacked = _stacked(card)
    g_model, e_model = _models(2)
    feat = collate.Featurizer(device=card, **FEAT)
    loss = step.LossConfig(**LOSS)
    pool = graphs.GraphPool()
    runs = []
    for model, pooled in ((g_model, pool), (e_model, None)):
        state = step.create_train_state(model, device=card, **OPT)
        gen = torch.Generator(device=card).manual_seed(1)
        fns = {ph: step.make_train_step(model, loss, *ph, feat, pooled)
               for ph in ((False, False), (True, True))}
        launch_counts.clear()
        rows = []
        for n in (K, K - 1):
            for i in range(n):
                phase = (True, True) if state.step > K else (False, False)
                key = feat.noise_key_for_step(state.step)
                raw = {k: v[i] for k, v in stacked.items()}
                state, m = fns[phase](
                    state, step.step_inputs(feat, raw, key), gen)
                rows.append(m)
        runs.append((rows, dict(launch_counts), gen))
    (grows, glaunch, ggen), (erows, elaunch, egen) = runs
    assert glaunch == elaunch
    for g, e in zip(grows, erows):
        for name in e:
            assert torch.equal(g[name], e[name]), name
    for a, b in zip(g_model.parameters(), e_model.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(ggen.get_state(), egen.get_state())
    # steps 1-4 plain (plain branch), 5 binarized (plain branch)
    assert pool.warmups == 2 and len(pool.captures) == 1
    assert pool.replays == K


def test_a_signature_warms_up_once_and_captures_at_its_second_call(card):
    """A signature seen once runs eagerly and is never captured; one seen
    three times warms up, captures once and replays twice. Every call's
    result is the eager one, and the launch ledger counts each call once
    (the capture's count taken back, each replay's added)."""
    from radmmm_torch.utils.launches import launched
    pool = graphs.GraphPool()

    def fn(x):
        launched("probe")
        return {"y": x["a"].square().sum(0)}

    g = graphs.Graphed(fn, pool, name="probe")
    once, thrice = (torch.rand(n, 5, device=card) for n in (3, 4))
    launch_counts.clear()
    assert torch.equal(g({"a": once})["y"], fn({"a": once})["y"])
    for _ in range(3):
        assert torch.equal(g({"a": thrice})["y"], fn({"a": thrice})["y"])
    assert (pool.warmups, len(pool.captures), pool.replays) == (2, 1, 2)
    assert pool.captures[0].signature[3:] == (
        (tuple(thrice.shape), thrice.dtype, thrice.device),)
    assert launch_counts["probe"] == 1 + 3 + 4      # g's calls and fn's
    launch_counts.clear()


def test_graphed_val_step_equals_eager(card):
    """The validation step through ``Graphed`` (the trainer's pool) on a
    featurized batch, three times (warm-up, capture and replay, replay),
    against the eager step: every metric bit for bit."""
    stacked = _stacked(card)
    (model,) = _models(1)
    state = step.create_train_state(model, device=card, **OPT)
    feat = collate.Featurizer(device=card, **FEAT)
    loss = step.LossConfig(**LOSS)
    pool = graphs.GraphPool()
    graphed = step.make_val_step(model, loss, pool=pool)
    eager = step.make_val_step(model, loss)
    batch = feat.featurize_raw({k: v[0] for k, v in stacked.items()}, 0)
    want = eager(state, batch)
    for _ in range(3):
        got = graphed(state, batch)
        assert set(got) == set(want)
        for name, v in want.items():
            assert torch.equal(got[name], v), name
    assert (pool.warmups, len(pool.captures), pool.replays) == (1, 1, 2)


def test_graphed_serving_equals_eager(card, tmp_path):
    """load_tts on the card captures every bucket's two stages at load; a
    request replays them: its PCM equals a second replay's bit for bit
    and the CPU's within 1 LSB, with the same lengths."""
    torch.manual_seed(3)
    model = TTSModel(tiny_config()).eval()
    voc = Generator(HiFiGANConfig(
        upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
        upsample_initial_channel=16, resblock_kernel_sizes=(3, 5),
        resblock_dilation_sizes=((1, 3), (1, 3)), n_mel_channels=8)).eval()
    path = str(tmp_path / "tts.pt")
    export_tts(model, path, vocoder=voc, sigma=0.8, buckets=TEXT_BUCKETS,
               frame_buckets=FRAME_BUCKETS)
    served = load_tts(path, device="cuda")
    assert len(served.graphs.captures) == len(TEXT_BUCKETS) * (
        1 + len(FRAME_BUCKETS))
    cpu = load_tts(path, device="cpu")
    rng = np.random.default_rng(4)
    for B, T in TEXT_BUCKETS:
        req = (rng.integers(1, 30, (B, T - 1)).astype(np.int32),
               np.full(B, T - 1, np.int32), np.zeros(B, np.int32),
               np.ones(B, np.int32), np.full(B, 5.0, np.float32),
               np.full(B, 0.3, np.float32), 5)
        a, lens = served(*req)
        b, _ = served(*req)
        c, clens = cpu(*req)
        assert torch.equal(a, b)
        assert torch.equal(lens.cpu(), clens)
        assert (a.cpu().int() - c.int()).abs().max() <= 1
    assert served.graphs.replays >= 2 * len(TEXT_BUCKETS) * 2


def test_captures_of_one_pool_share_its_memory(card):
    """A second capture into a pool reuses the memory the first freed (its
    intermediates): every capture runs on the pool's one stream, and the
    caching allocator reuses a block only on the stream that allocated
    it. The pool grows by 64 MiB of intermediates at the first capture
    and by at most one 2 MiB segment (the output) at the second."""
    pool = graphs.GraphPool()

    def fn(x):
        h = (x["a"] * 2).exp()              # 64 MiB, freed before the end
        return h.sum()

    a = torch.rand(4096, 4096, device=card)
    first = graphs.Graphed(fn, pool, name="first")
    second = graphs.Graphed(fn, pool, name="second")
    want = fn({"a": a})
    for g in (first, second):
        assert torch.equal(g({"a": a}), want)       # the warm-up
        assert torch.equal(g({"a": a}), want)       # captured, replayed
        assert torch.equal(g({"a": a}), want)       # a replay
    grew = [c.pool_bytes for c in pool.captures]
    assert grew[0] >= 64 * 2**20
    assert grew[1] <= 2 * 2**20


VOC_GEN = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
               upsample_initial_channel=16, resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1, 3),), n_mel_channels=8)
VOC_WG = dict(n_mel_channels=8, n_flows=4, n_group=4, n_early_every=2,
              n_early_size=2, wn_channels=8, wn_layers=2, upsample_kernel=32)
VOC_TRAIN = dict(segment_size=512, hop_length=16, filter_length=64,
                 win_length=64, n_mel_channels=8, learning_rate=1e-3)


@pytest.mark.parametrize("kind", ["hifigan", "waveglow"])
def test_graphed_vocoder_steps_equal_eager(card, kind):
    """Six steps of a trainer through its graphs against a trainer built
    alike with ``pool=None``: every metric and parameter bit for bit.
    HiFi-GAN blurs with p 0.5 from seed 1 (steps 0, 2 and 4), so both
    branches (two signatures) run, each warmed up at its first step and
    captured at its second."""
    from radmmm_torch.training import vocoder_train as tvt
    runs = []
    for pool in (tvt.OWN_POOL, None):
        if kind == "hifigan":
            tr = tvt.HiFiGANTrainer(HiFiGANConfig(**VOC_GEN),
                                    tvt.VocoderTrainConfig(
                                        **VOC_TRAIN, blur_p=0.5, seed=1),
                                    device=card, pool=pool)
        else:
            tr = tvt.WaveGlowTrainer(VOC_WG, tvt.VocoderTrainConfig(
                **VOC_TRAIN), device=card, pool=pool)
        g = torch.Generator(device=card).manual_seed(0)
        rows = [tr.train_step({"audio": torch.rand(
            (2, 512), generator=g, device=card) * 0.6 - 0.3})
            for _ in range(6)]
        runs.append((tr, rows))
    (gtr, grows), (etr, erows) = runs
    for g, e in zip(grows, erows):
        for name in e:
            assert torch.equal(g[name], e[name]), name
    for name in (("gen", "mpd", "msd") if kind == "hifigan" else ("model",)):
        for a, b in zip(getattr(gtr, name).parameters(),
                        getattr(etr, name).parameters()):
            assert torch.equal(a, b), name
    signatures = 2 if kind == "hifigan" else 1
    assert gtr.pool.warmups == len(gtr.pool.captures) == signatures
    assert gtr.pool.replays == 6 - signatures and etr.pool is None


def test_trainer_samples_graphed_equal_eager(card, tmp_path):
    """The trainer's sample programs (infer at its prompts, the binarized
    eval forward, reconstruct) and the vocoder's apply with its Denoiser,
    over three validations with a training step between each, through the
    trainer's pool against a trainer whose pool is None: every output bit
    for bit; each program warms up at the first validation, captures at
    the second and replays at the third, with the weights of its step."""
    from radmmm_torch.training.loop import Trainer, TrainerConfig
    from radmmm_torch.vocoder.hifigan import Denoiser
    from radmmm_torch.vocoder.utils import hifigan_fns, vocode_program

    class Eager(Trainer):
        def _step_pool(self):
            return None

    stacked = _stacked(card)
    feat = collate.Featurizer(device=card, **FEAT)
    batch = feat.featurize_raw({k: v[0] for k, v in stacked.items()}, 0)
    torch.manual_seed(0)
    voc, _ = hifigan_fns(Generator(HiFiGANConfig(**VOC_GEN)), False, card)
    den = Denoiser(voc, n_mel_channels=8, filter_length=64, win_length=64,
                   device=card)
    rng = np.random.default_rng(2)
    b = {"text": torch.from_numpy(rng.integers(1, 30, (2, 6))).to(card),
         "text_lens": torch.tensor([6, 4], device=card),
         **{k: torch.tensor([0, 2], device=card)
            for k in ("spk_id", "accent_id")},
         "speaker_f0_mean": torch.tensor([5.0, 5.2], device=card),
         "speaker_f0_std": torch.tensor([0.3, 0.3], device=card)}
    b["accent_id"] = b["accent_id"] % 2
    runs = []
    for cls in (Trainer, Eager):
        tr = cls(tiny_config(), step.LossConfig(**LOSS), TrainerConfig(
            output_directory=str(tmp_path / cls.__name__), device=card.type,
            max_infer_frames=32, learning_rate=1e-2,
            save_code_snapshot=False))
        state = tr._init_state(None)
        vocode = vocode_program("hifigan", voc, den, tr._step_pool())
        gen = tr._generator(1)
        outs = []
        for v in range(3):
            with torch.no_grad():
                tr.model.cache_inverses()
                out = tr._infer(b, tr._generator(0))
                outs.append([out, tr._val_forward(batch),
                             tr._reconstruct(batch, tr._generator(0)),
                             vocode(out["mel"])])
            state, _ = tr._train_step_fn(False, False)(state, batch, gen)
        runs.append((tr, outs))
    (gtr, gouts), (_, eouts) = runs
    flat = torch.utils._pytree.tree_leaves
    for g, e in zip(gouts, eouts):
        for x, y in zip(flat(g), flat(e)):
            assert torch.equal(x, y)
    assert not torch.equal(gouts[0][2]["mel"], gouts[2][2]["mel"])
    names = collections.Counter(c.name for c in gtr._graph_pool.captures)
    assert all(names[n] == 1 for n in ("tts_infer", "val_forward",
                                       "reconstruct", "vocode"))


# the featurizer's kinds of signature: F0 method, cached F0 tracks, mel
# noise, the distance transform
FEAT_QUIET = dict(FEAT, mel_noise_scale=0.0)
FEAT_KINDS = {"pyin": dict(f0_method="pyin"), "yin": dict(f0_method="yin"),
              "cached_f0": dict(f0_method="pyin"),
              "noise": dict(f0_method="pyin", mel_noise_scale=0.05),
              "distance": dict(f0_method="pyin", distance_tx_unvoiced=True)}


def _feat_host(seed: int, seconds=(0.19, 0.16), cached: bool = False):
    """A host batch of voiced utterances of ``seconds``, with F0 cache
    tracks where ``cached``."""
    rng = np.random.default_rng(seed)
    items = []
    for b, sec in enumerate(seconds):
        t = np.arange(int(sec * SR)) / SR
        audio = (0.5 * np.sin(2 * np.pi * (150.0 + 30 * b + seed) * t)
                 + 0.003 * rng.standard_normal(t.size)).astype(np.float32)
        n = 1 + len(audio) // FEAT["hop_length"]
        items.append({
            "audio": audio, "text_encoded": rng.integers(1, 30, 7 - b),
            "speaker_id": b, "accent_id": b % 2, "speaker_f0_mean": 5.0,
            "speaker_f0_std": 0.3, "speaker_energy_mean": 0.5,
            "speaker_energy_std": 0.15, "audiopath": f"u{b}.wav",
            "text_raw": "x", "language": "en_US", "idx": b,
            "cached_f0": np.stack([
                rng.uniform(100, 300, n), rng.integers(0, 2, n),
                rng.uniform(0, 1, n)]).astype(np.float32) if cached
            else None})
    return collate.collate_host(items, hop_length=FEAT["hop_length"],
                                audio_frames_multiple=16)


def _same_batch(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("kind", sorted(FEAT_KINDS))
def test_graphed_featurizer_equals_eager(card, kind):
    """A featurizer's calls through its graphs (its own pool) against a
    featurizer built alike with ``pool=None``, four host batches of one
    shape: every key bit for bit (the mel noise from the same keys); the
    first call warms up, the second captures, and every call from the
    second replays."""
    kw = dict(FEAT_QUIET, **FEAT_KINDS[kind])
    graphed = collate.Featurizer(device=card, **kw)
    eager = collate.Featurizer(device=card, pool=None, **kw)
    for seed in range(4):
        host = _feat_host(seed, cached=kind == "cached_f0")
        _same_batch(graphed(host), eager(host))
    pool = graphed.pool
    assert (pool.warmups, len(pool.captures), pool.replays) == (1, 1, 3)
    assert eager.pool is None


def test_loader_threads_replay_while_a_step_captures(card):
    """Two threads call one featurizer at two batch shapes (warming up,
    capturing and replaying its graphs) while this thread warms up,
    captures and replays a training step in another pool: every batch is
    the eager featurizer's, the steps' metrics and parameters an eager
    model's bit for bit, the step's launches counted as the eager steps
    count them beside one pYIN Viterbi launch a featurize call (warm-up,
    capture and replays alike), and the cyclic collector on again after
    the captures."""
    feat = collate.Featurizer(device=card, **FEAT_QUIET)
    eager = collate.Featurizer(device=card, pool=None, **FEAT_QUIET)
    hosts = [_feat_host(1), _feat_host(2, seconds=(0.31, 0.22))]
    want = [{k: v.cpu() if isinstance(v, torch.Tensor) else v
             for k, v in eager(h).items()} for h in hosts]
    batch = eager.featurize_raw({k: torch.from_numpy(v).to(card) for k, v in
                                 eager.raw_arrays(_feat_host(3)).items()}, 0)
    g_model, e_model = _models(2)
    loss = step.LossConfig(**LOSS)
    gstate = step.create_train_state(g_model, device=card, **OPT)
    estate = step.create_train_state(e_model, device=card, **OPT)
    pool = graphs.GraphPool()
    gfn = step.make_train_step(g_model, loss, False, False, pool=pool)
    efn = step.make_train_step(e_model, loss, False, False)
    ggen = torch.Generator(device=card).manual_seed(1)
    egen = torch.Generator(device=card).manual_seed(1)
    start = threading.Barrier(3)
    got, errors = [[], []], []

    def load(i):
        try:
            start.wait(30)
            for _ in range(6):
                b = feat(hosts[i])
                got[i].append({k: v.cpu() if isinstance(v, torch.Tensor)
                               else v for k, v in b.items()})
        except BaseException as e:       # raised below, in the test
            errors.append(e)

    threads = [threading.Thread(target=load, args=(i,))
               for i in range(2)]
    for t in threads:
        t.start()
    launch_counts.clear()
    start.wait(30)
    gmet = [gfn(gstate, batch, ggen)[1] for _ in range(3)]
    for t in threads:
        t.join(120)
    glaunch = dict(launch_counts)
    assert not errors and gc.isenabled()
    launch_counts.clear()
    emet = [efn(estate, batch, egen)[1] for _ in range(3)]
    assert glaunch.pop("pyin_viterbi") == 2 * 6
    assert glaunch == dict(launch_counts)
    for g, e in zip(gmet, emet):
        for name in e:
            assert torch.equal(g[name], e[name]), name
    for a, b in zip(g_model.parameters(), e_model.parameters()):
        assert torch.equal(a, b)
    for i in range(2):
        assert len(got[i]) == 6
        for b in got[i]:
            _same_batch(b, want[i])
    assert (feat.pool.warmups, len(feat.pool.captures),
            feat.pool.replays) == (2, 2, 10)
    assert (pool.warmups, len(pool.captures), pool.replays) == (1, 1, 2)


class _Utterances:
    """An un-augmented dataset as ``build_f0_cache`` reads one: eight
    voiced utterances of 0.30-0.58 s at 22,050 Hz (one padded shape at 64
    frames a multiple, so four batches of two)."""
    augmentations = None
    sampling_rate = SR

    def __init__(self):
        from types import SimpleNamespace
        rng = np.random.default_rng(6)
        self.audio = []
        for i in range(8):
            t = np.arange(int((0.30 + 0.04 * i) * SR)) / SR
            self.audio.append((0.5 * np.sin(2 * np.pi * (140 + 15 * i) * t)
                               + 0.003 * rng.standard_normal(t.size)
                               ).astype(np.float32))
        self.data = [SimpleNamespace(duration=len(a) / SR)
                     for a in self.audio]

    def __getitem__(self, i):
        return {"audio": self.audio[i], "audiopath": f"utt{i}.wav"}


def test_graphed_f0_cache_equals_eager(card, tmp_path):
    """``build_f0_cache`` through its graphs (pYIN) against the eager
    build: the same records bit for bit; of its four batches of one shape
    the first warms up, the second captures and the last three replay."""
    from radmmm_torch.data.f0_cache import build_f0_cache, f0_key
    from radmmm_torch.native import FeatureCache
    data = _Utterances()
    pool = graphs.GraphPool()
    paths = [str(tmp_path / way) for way in ("graphed", "eager")]
    for path, p in zip(paths, (pool, None)):
        assert build_f0_cache(data, path, batch_size=2, device=card,
                              pool=p) == 8
    assert (pool.warmups, len(pool.captures), pool.replays) == (1, 1, 3)
    g, e = (FeatureCache(p) for p in paths)
    for i in range(8):
        key = f0_key(f"utt{i}.wav")
        assert np.array_equal(g.get_array(key), e.get_array(key)), key
