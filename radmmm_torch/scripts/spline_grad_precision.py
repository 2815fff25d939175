"""Why float32 gradients of a spline flow's FiLM stacks differ between runs.

    python -m radmmm_torch.scripts.spline_grad_precision [--seed 0]
        [--batch 8] [--frames 512]

Builds configs/radtts_model.yaml's decoder with two spline steps
(``n_splines`` 2) and no context LSTM (the LSTM kernel is float32 only),
gives the couplings' zero-initialised last convs small random weights
(as chip_smoke.py does), and takes one training forward and backward of
the flow loss from the same weights and batch four times: on the card in
float32, on the CPU in float32, on the card in float64 (the splines
too), and on the card in float32 with a fault planted, the gradient into
one FiLM block's hidden conv scaled by 1.01 (a 1% error in one conv's
backward).

For each pair of runs it counts, on valid frames, the two discrete
events that can set one element's gradient apart: a pre-activation of a
FiLM leaky ReLU on the other side of 0 (slope 1 against 0.01) and a
spline input in another bin. Then, for the spline couplings' parameters
and for all others apart, it prints the worst leaf by two readings: the
largest difference over the leaf's largest gradient, and the difference's
Frobenius norm over the leaf's; both taken at least 1e-6 of the tree's
largest gradient (leaves whose gradient is zero in exact arithmetic).
"""
from __future__ import annotations

import argparse
import copy

import numpy as np
import torch

from radmmm_torch.losses.flow import compute_flow_loss
from radmmm_torch.models.flow_decoder import RADMMMFlow
from radmmm_torch.ops.coupling import WN, FiLMResBlock, FiLMStack, \
    SplineCoupling
from radmmm_torch.utils.config import (load_configs,
                                       translate_reference_model_config)
from radmmm_torch.utils.device import card_line, resolve_device
from radmmm_torch.utils.masking import SeqLens

FLOOR = 1e-6
FAULT_BLOCK, FAULT_SCALE = (0, 2), 1.01     # (flow, FiLM block), factor


def _watch(model) -> dict:
    """Forward hooks that record, in call order, the FiLM leaky ReLUs'
    pre-activations (``kink``) and the spline couplings' bins with the
    points' inside-[0, 1) flags (``bin``)."""
    rec = {"kink": [], "bin": []}
    for blk in model.modules():
        if isinstance(blk, FiLMResBlock):
            seen, c = {}, blk.out_channels

            def keep(key, seen=seen):
                return lambda m, i, o: seen.__setitem__(key, o.detach())

            def pre(m, i, o, seen=seen, c=c):
                c1 = seen["c1"]
                rec["kink"] += [seen["x1"],
                                o.detach() * (c1[..., :c] + 1.0) + c1[..., c:]]

            blk.input_conv.register_forward_hook(keep("x1"))
            blk.cond_conv.register_forward_hook(keep("c1"))
            (blk.bn or blk.hidden_conv).register_forward_hook(pre)
        if isinstance(blk, SplineCoupling):
            z_in = {}

            def take_z(m, args, z_in=z_in):
                z_in["z"] = args[0].detach()

            def bins(m, i, params, sc=blk, z_in=z_in):
                z1 = z_in["z"][..., sc.n_half:]
                x = (z1 - sc.left) / (sc.right - sc.left)
                B, T = x.shape[:2]
                k = sc.n_bins // 2
                w = torch.softmax(params.detach().reshape(
                    B, T, sc.n_half, sc.n_bins)[..., :k], dim=-1)
                cum = torch.cumsum(w, dim=-1)
                cum[..., -1] = 1.0
                xn = x.clamp(0.0, 1.0 - torch.finfo(torch.float32).eps)
                rec["bin"].append((
                    (cum < xn[..., None]).sum(-1).clamp(max=k - 1),
                    (x >= 0.0) & (x < 1.0)))

            blk.register_forward_pre_hook(take_z)
            blk.film.register_forward_hook(bins)
    return rec


def _plant(model) -> None:
    """The fault: the gradient into one FiLM block's hidden conv times
    FAULT_SCALE."""
    flow, block = FAULT_BLOCK
    blk = getattr(model.flows[flow].coupling.film, f"block_{block}")

    def pre(m, args):
        args[0].register_hook(lambda g: g * FAULT_SCALE)

    blk.hidden_conv.register_forward_pre_hook(pre)


def _step(model, arrays, lens, dtype, device) -> float:
    t = {k: torch.tensor(v, dtype=dtype, device=device)
         for k, v in arrays.items()}
    T = t["mel"].shape[1]
    sl = SeqLens.create(torch.tensor(lens, device=device), T)
    out = model(t["mel"], t["spk"], t["ctx"], sl, f0=t["f0"],
                energy_avg=t["en"], accent_vecs=t["acc"], train=True)
    g = sl.downsample(2)
    loss, _ = compute_flow_loss(out["z_mel"], out["log_det_W_list"],
                                out["log_s_list"], g.lengths.sum().to(dtype),
                                out["z_mel"].shape[-1], g.fmask(dtype))
    loss.backward()
    return loss.item()


def _flips(a: dict, b: dict, valid: torch.Tensor) -> tuple:
    """(leaky-ReLU sign flips, spline bin flips) between two runs' records
    on valid frames."""
    kinks = sum(int((((x.cpu() > 0) != (y.cpu() > 0)) & valid[..., None])
                    .sum()) for x, y in zip(a["kink"], b["kink"]))
    bins = sum(int(((ba.cpu() != bb.cpu()) & ia.cpu() & ib.cpu()
                    & valid[..., None]).sum())
               for (ba, ia), (bb, ib) in zip(a["bin"], b["bin"]))
    return kinks, bins


def _worst(got, want, spline: bool) -> tuple:
    """((max reading, leaf), (Frobenius reading, leaf)) of the worst
    leaves among the spline couplings' (or all others')."""
    wg = {n: p.grad.double().cpu() for n, p in want.named_parameters()}
    gg = {n: p.grad.double().cpu() for n, p in got.named_parameters()}
    tree = max(float(w.abs().max()) for w in wg.values())
    maxes, frobs = [], []
    for n, w in wg.items():
        if (".film." in n) != spline:
            continue
        d = gg[n] - w
        maxes.append((float(d.abs().max())
                      / max(float(w.abs().max()), FLOOR * tree), n))
        frobs.append((float(d.norm()) / max(float(w.norm()), FLOOR * tree),
                      n))
    return max(maxes), max(frobs)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=512)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dec = dict(translate_reference_model_config(load_configs(
        ["configs/radtts_model.yaml"]))["tts"]["decoder"], n_splines=2,
        use_context_lstm=False)
    torch.manual_seed(args.seed)
    model = RADMMMFlow(**dec)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (WN, FiLMStack)):
                m.end.weight.normal_(0.0, 1e-3)
                m.end.bias.normal_(0.0, 1e-3)
    rng = np.random.default_rng(args.seed + 11)
    B, T = args.batch, args.frames
    arrays = dict(mel=rng.standard_normal((B, T, 80)),
                  spk=rng.standard_normal((B, 16)),
                  ctx=rng.standard_normal((B, T, 512)),
                  acc=rng.standard_normal((B, 8)),
                  f0=rng.uniform(4, 6, (B, T)), en=rng.uniform(0, 1, (B, T)))
    lens = np.asarray([T - 16 * i for i in range(B)])
    valid = torch.arange(T // 2)[None, :] < torch.tensor(lens // 2)[:, None]
    runs = {"card f32": (dev, torch.float32), "cpu f32": ("cpu", torch.float32),
            "card f64": (dev, torch.float64),
            "card f32 with the fault": (dev, torch.float32)}
    models, recs = {}, {}
    print(card_line())
    for name, (where, dtype) in runs.items():
        m = copy.deepcopy(model).to(where, dtype)
        recs[name] = _watch(m)
        if "fault" in name:
            _plant(m)
        models[name] = m
        print(f"{name}: flow loss {_step(m, arrays, lens, dtype, where):.9f}"
              f" (B={B}, T_mel={T})")
    print(f"the fault: the gradient into flows.{FAULT_BLOCK[0]} FiLM "
          f"block_{FAULT_BLOCK[1]}'s hidden conv times {FAULT_SCALE}")
    pairs = (("card f32", "card f64"), ("cpu f32", "card f64"),
             ("card f32", "cpu f32"), ("card f32 with the fault", "cpu f32"))
    for a, b in pairs:
        kinks, bins = _flips(recs[a], recs[b], valid)
        print(f"{a} against {b}: {kinks} FiLM leaky-ReLU pre-activations "
              f"and {bins} spline bins on the other side, valid frames")
        for spline in (True, False):
            (mx, mx_leaf), (fr, fr_leaf) = _worst(models[a], models[b],
                                                 spline)
            which = "spline couplings" if spline else "all other leaves"
            print(f"  {which}: worst max-over-max {mx:.3e} ({mx_leaf}), "
                  f"worst Frobenius {fr:.3e} ({fr_leaf})")


if __name__ == "__main__":
    main()
