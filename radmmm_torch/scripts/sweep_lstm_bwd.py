"""Time the LSTM backward kernel under every plan that fits a shape, on
the card, each checked against its plain twin.

    python -m radmmm_torch.scripts.sweep_lstm_bwd [--shapes 2x260x96x8,...]

A shape is L x H x T x B (lanes, hidden units, steps, batch), with the
ragged masks and random saved states of ``chip_smoke.py``'s kernels phase.
The plans: one cluster per lane at 8 and at 16 CTAs, and the cooperative
grid at 8 hidden units a CTA, each with its partial product split into 1,
2 and 4 chunks; those past a block's shared memory are skipped, and a
launch the card refuses is reported. Prints ms and us a step for each, and the plan that
``card_backward_plan`` picks. Needs a card; raises without one.
"""
from __future__ import annotations

import argparse

import torch

from radmmm_torch.ops import lstm_kernel as lk
from radmmm_torch.utils.device import card_line, resolve_device

TRAIN_SHAPES = "2x260x96x8,2x128x96x8,6x128x512x8,2x528x256x8"


def _inputs(L, H, T, B, dev):
    g = torch.Generator(device=dev).manual_seed(0)
    xp = torch.randn((L, T, B, 4 * H), generator=g, device=dev)
    wh = (torch.rand((L, H, 4 * H), generator=g, device=dev) * 2 - 1) \
        / H ** 0.5
    lens = torch.tensor([T - i * T // (B + 1) for i in range(B)])
    mask = (torch.arange(T)[:, None] < lens[None, :]).float().to(dev)
    rev = [bool(l % 2) for l in range(L)]
    _, act, cs, _ = lk.lstm_recurrence_reference(xp, mask, wh, rev, True)
    dout = torch.randn((L, T, B, H), generator=g, device=dev)
    return dout, act, cs, mask, wh, rev


def _plans(B, H):
    """Clusters of 8 and 16 CTAs a lane and the grid at 8 units a CTA,
    each with 1, 2 and 4 chunks, within a block's shared memory."""
    limits = lk.card_limits()
    for route, n_cta in (("cluster", 8), ("cluster", 16), ("grid", None)):
        hb = -(-H // n_cta) if n_cta else 8
        n = -(-H // hb)
        for ks in (1, 2, 4):
            smem = lk._bwd_smem(B, H, hb, ks, n, route == "cluster")
            if B * hb <= lk._BWD_THREADS and smem <= limits.smem_per_block:
                yield lk.BackwardPlan(route, n, hb, ks, smem)


def _ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=TRAIN_SHAPES)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    print(card_line(), flush=True)
    for shape in args.shapes.split(","):
        L, H, T, B = (int(v) for v in shape.split("x"))
        dout, act, cs, mask, wh, rev = _inputs(L, H, T, B, dev)
        want = lk.lstm_recurrence_backward_reference(dout, act, cs, mask,
                                                     wh, rev)
        print(f"L={L} H={H} T={T} B={B}: the plan picks "
              f"{lk.card_backward_plan(L, B, H)}", flush=True)
        for plan in _plans(B, H):
            def run():
                return lk._backward_kernel(dout, act, cs, mask, wh, rev,
                                           plan=plan)
            try:
                err = (run() - want).abs().max().item()
            except RuntimeError as e:   # a cluster or grid not resident
                print(f"  {plan.route} {plan.n_cta} x {plan.hb} ks "
                      f"{plan.ks}: refused ({e})", flush=True)
                continue
            ms = _ms(run)
            print(f"  {plan.route} {plan.n_cta} CTAs x {plan.hb} units, ks "
                  f"{plan.ks}: {ms:.4f} ms, {ms * 1e3 / T:.2f} us/step, "
                  f"max_abs_err {err:.1e}", flush=True)


if __name__ == "__main__":
    main()
