"""Time the LSTM recurrence's forward or backward kernel under every plan
that fits a shape, on the card, each checked against its plain twin.

    python -m radmmm_torch.scripts.sweep_lstm [--direction fwd|bwd]
        [--shapes 2x260x96x8,...] [--bf16]

A shape is L x H x T x B (lanes, hidden units, steps, batch), with the
ragged masks and random inputs of ``chip_smoke.py``'s kernels phase (the
forward saves its states, as in training; the backward runs on random
saved states from the twin). The plans: one cluster per lane at 8 and at
16 CTAs, and the cooperative grid at 8 and 16 hidden units a CTA, each
with its product split into 1, 2, 4, 8 and 16 chunks (the forward) or 1,
2 and 4 (the backward); those past a block's threads or shared memory are
skipped, and a launch the card refuses is reported. Prints the plan that
``card_forward_plan`` or ``card_backward_plan`` picks, then ms and us a
step for it and for each other plan: after a warm-up of the picked plan,
every plan is timed in order and again in reverse order, and the less of
its two times is printed beside both. ``--bf16`` sweeps the bf16 kernels
(``csrc/lstm_recurrence_bf16.cu``) against the bf16 twins: the same
routes, the forward's warps split over 1, 2, 3, 4, 6 and 12 along its
reduction, the backward's one split. Needs a card; raises without one.
"""
from __future__ import annotations

import argparse

import torch

from radmmm_torch.ops import lstm_kernel as lk
from radmmm_torch.utils.device import card_line, resolve_device

TRAIN_SHAPES = "2x260x96x8,2x128x96x8,6x128x512x8,2x528x256x8"
# per direction and bf16: its kernel's threads, shared memory, and the
# product's splits the sweep tries
KERNELS = {("fwd", False): (lk._FWD_THREADS, lk._fwd_smem, (1, 2, 4, 8, 16)),
           ("bwd", False): (lk._BWD_THREADS, lk._bwd_smem, (1, 2, 4)),
           ("fwd", True): (lk._BF16_THREADS, lk._fwd_smem_bf16,
                           (1, 2, 3, 4, 6, 12)),
           ("bwd", True): (lk._BF16_THREADS, lk._bwd_smem_bf16, (1,))}


def _inputs(L, H, T, B, dev):
    g = torch.Generator(device=dev).manual_seed(0)
    xp = torch.randn((L, T, B, 4 * H), generator=g, device=dev)
    wh = (torch.rand((L, H, 4 * H), generator=g, device=dev) * 2 - 1) \
        / H ** 0.5
    lens = torch.tensor([T - i * T // (B + 1) for i in range(B)])
    mask = (torch.arange(T)[:, None] < lens[None, :]).float().to(dev)
    rev = [bool(l % 2) for l in range(L)]
    return xp, mask, wh, rev


def _plans(direction, B, H, bf16=False):
    """Clusters of 8 and 16 CTAs a lane and the grid at 8 and 16 units a
    CTA, each with every chunk count of the direction, within a block's
    threads and shared memory."""
    threads, smem_fn, chunks = KERNELS[direction, bf16]
    limits = lk.card_limits(*lk._kernel(direction, bf16))
    for route, n_cta, hb in (("cluster", 8, None), ("cluster", 16, None),
                             ("grid", None, 8), ("grid", None, 16)):
        hb = hb or -(-H // n_cta)
        n = -(-H // hb)
        for ks in chunks:
            if direction == "fwd" and not bf16 and 2 * hb * ks > threads:
                continue
            smem = smem_fn(B, H, hb, ks, n, route == "cluster")
            if B * hb <= threads and smem <= limits.smem_per_block:
                yield lk.Plan(route, n, hb, ks, smem)


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


def _case(direction, L, H, T, B, dev, bf16=False):
    """(run(plan), the twin's result(s), the card's plan) at one shape."""
    xp, mask, wh, rev = _inputs(L, H, T, B, dev)
    if direction == "fwd":
        def run(plan):
            return lk._forward_kernel(xp, mask, wh, rev, save=True,
                                      plan=plan, bf16=bf16)
        return run, lk.lstm_recurrence_reference(
            xp, mask, wh, rev, True, bf16=bf16), \
            lk.card_forward_plan(L, B, H, bf16)
    _, act, cs, _ = lk.lstm_recurrence_reference(xp, mask, wh, rev, True,
                                                 bf16=bf16)
    dout = torch.randn((L, T, B, H), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(1))

    def run(plan):
        return lk._backward_kernel(dout, act, cs, mask, wh, rev, plan=plan,
                                   bf16=bf16)
    return run, (lk.lstm_recurrence_backward_reference(
        dout, act, cs, mask, wh, rev, bf16=bf16),), \
        lk.card_backward_plan(L, B, H, bf16)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--direction", choices=("fwd", "bwd"), default="bwd")
    ap.add_argument("--shapes", default=TRAIN_SHAPES)
    ap.add_argument("--bf16", action="store_true",
                    help="the kernels' bf16 variants")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    print(card_line(), flush=True)
    for shape in args.shapes.split(","):
        L, H, T, B = (int(v) for v in shape.split("x"))
        run, want, picked = _case(args.direction, L, H, T, B, dev, args.bf16)
        print(f"{args.direction} L={L} H={H} T={T} B={B}: the plan picks "
              f"{picked}", flush=True)
        plans = [picked] + [p for p in _plans(args.direction, B, H,
                                              args.bf16) if p != picked]
        ok = []
        for plan in plans:
            try:
                got = run(plan)
                got = got if isinstance(got, tuple) else (got,)
                err = max((g - w).abs().max().item()
                          for g, w in zip(got, want))
            except RuntimeError as e:   # a cluster or grid not resident
                print(f"  {plan.route} {plan.n_cta} x {plan.hb} ks "
                      f"{plan.ks}: refused ({e})", flush=True)
                continue
            ok.append((plan, err))
        # the card's clocks up first, then every plan timed twice, in order
        # and in reverse order, so that no plan gains from its place
        _ms(lambda: run(picked), reps=200)
        ms = {}
        for plan, _ in ok + ok[::-1]:
            ms.setdefault(plan, []).append(_ms(lambda: run(plan)))
        for plan, err in ok:
            t = min(ms[plan])
            print(f"  {plan.route} {plan.n_cta} CTAs x {plan.hb} units, ks "
                  f"{plan.ks}: {t:.4f} ms, {t * 1e3 / T:.2f} us/step (the "
                  f"less of {ms[plan][0]:.4f} and {ms[plan][1]:.4f}), "
                  f"max_abs_err {err:.1e}", flush=True)

if __name__ == "__main__":
    main()
