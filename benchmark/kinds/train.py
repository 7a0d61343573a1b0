"""Training updates: `train.make_train_step` over micro-batches shipped to
the card as the training loop ships them (`data.prefetch` with
`to_device`), `accumulation_steps` micro-steps a real update, dropout
drawn from one seeded generator on the card.

Set-up makes one train state and step and drives them through the first
`check_updates` updates on distinct micro-batches, which captures the
step's programs; the window goes on with the same objects. Check: the
reference trains the same weights on the same micro-batches, with
dropout masks drawn from a generator of the same seed, for those updates:
each micro-step's loss terms (every decoder layer's cross-entropy and
coordinate L1; `loss_gap`, their mean relative gap, and `total_loss_gap`,
the worst step's total), the clipped gradient of the first update as
Adam's first moment holds it (`grad_gap` of the worst leaf,
`grad_gap_median` of the median leaf), and the change of the parameters
over the checked updates (`change_gap`, `change_gap_median`, over the
leaves whose reference gradient is at least a thousandth of the median
leaf's).

With the control on, set-up also keeps the coordinates of every decoder
layer that each checked micro-step's forward produced, and the check
follows the reference a third time with the program's signs of
(coordinate - target) in its L1 terms: it counts the positions where
those signs differ from the reference's own, and reads the gaps again
(`signs`). Two witnesses with no program in them follow it again, each
against the plain reference: in float32 with every sampling location of
the deformable attention rounded to bfloat16 (`loc_bf16`), and whole
under bfloat16 autocast (`autocast_bf16`).
"""

from __future__ import annotations

import itertools
import threading
import time

import torch

import check as checks
import counts
import traffic
from reference.model import MSDeformAttn, RefCAPE
from reference.train import AdamW, criterion, grads_of, leaf_gaps, leaf_norms

ADAM_B1 = 0.9


def _feed(run):
    """An endless prefetched stream of the pool's micro-batches on the
    device, stopped by `run.state['stop']`."""
    from cape_tpu_torch.data.prefetch import prefetch, to_device
    stop = run.state["stop"]
    pool = run.state["pool"]

    def batches():
        for b in itertools.cycle(pool):
            if stop.is_set():
                return
            yield b

    dev = run.device
    return prefetch(batches(), transform=lambda b: to_device(b, dev))


def pools(t, c, seed):
    """The cell's traffic, made from the seed."""
    return traffic.train(t, c, seed)


def work(p):
    """What no seed changes: the pool's size and its supports' keypoint
    counts."""
    return (len(p), sorted(int((~m).sum()) for b in p
                           for m in b["support_mask"]))


def setup(run) -> None:
    from cape_tpu_torch import graphs
    from cape_tpu_torch.train import create_train_state, make_train_step
    t, st = run.t, run.state
    cfg = run.port_config()
    model = run.port_model(cfg)
    spe = t["steps_per_epoch"]
    state = create_train_state(cfg, model, spe, masters=run.weights)
    step = make_train_step(model, cfg, spe)
    run.log(graphs.describe_step_route(model, cfg))
    gen = torch.Generator(device=run.device).manual_seed(run.seed + 7)
    st.update(model=model, cfg=cfg, state=state, step=step, gen=gen,
              pool=pools(t, run.c, run.seed), stop=threading.Event())
    st["feed"] = _feed(run)
    run.mark("pools made")
    if run.control:
        st["coords"], kept = [], _keep_coords(model)
    k = run.c["accumulation_steps"]
    losses = []
    for j in range(t["check_updates"] * k):
        _, m = step(state, next(st["feed"]), gen)
        losses.append(m)
        if run.control:
            st["coords"].append(kept["coords"].clone())
        if j == k - 1:
            run.sync()
            st["mu1"] = [x.clone() for x in state.opt_state.mu]
    run.sync()
    run.mark("checked updates done")
    st["losses"] = [{k: float(v) for k, v in m.items() if k != "grad_norm"}
                    for m in losses]
    st["masters"] = [x.clone() for x in state.opt_state.masters]
    st["names"] = list(state.opt_state.names)


def _keep_coords(model):
    """A forward hook that copies every decoder layer's coordinates
    (layers, B, L, 2) into one buffer; the copy is captured with the step
    and so runs in each replay."""
    kept = {}

    def hook(module, args, out):
        x = torch.cat([out["aux_coords"], out["pred_coords"][None]]).float()
        if "coords" not in kept:
            kept["coords"] = torch.empty_like(x)
        kept["coords"].copy_(x.detach())

    model.register_forward_hook(hook)
    return kept


def window(run):
    st = run.state
    k = run.c["accumulation_steps"]
    updates = 0
    t0 = time.perf_counter()
    while True:
        for _ in range(k):
            st["step"](st["state"], next(st["feed"]), st["gen"])
        updates += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.sync()
    wall = time.perf_counter() - t0
    images = run.t["episodes"] * run.t["queries"]
    run.units = {"attempted": updates, "failed": 0, "updates": updates,
                 "wall_s": wall}
    run.work = {"flops": updates * counts.train_update_flops(run.c, images)}
    return {"train_update_ms": wall / updates * 1e3}


def traced_units(run) -> None:
    st = run.state
    n = run.t["traced_updates"]
    for _ in range(n * run.c["accumulation_steps"]):
        st["step"](st["state"], next(st["feed"]), st["gen"])
    run.traced_work = {"updates": n}


def release(run) -> None:
    from cape_tpu_torch import graphs
    st = run.state
    st["stop"].set()
    for _ in st["feed"]:          # drain, so that the producer ends
        pass
    graphs.clear(st["model"])
    for key in ("feed", "step", "state", "model"):
        del st[key]


def _follow(run, ref: RefCAPE, half: bool = False, prog_coords=None,
            autocast: bool = False):
    """The reference's losses, first clipped gradient and parameters after
    the checked updates; with `half`, the fault of a step that leaves out
    the second half of each micro-batch and means over the rest. With
    `prog_coords` (the program's coordinates of each micro-step), the L1
    terms take the program's signs, and `run.state["flips"]` counts the
    supervised elements whose sign differs from the reference's own."""
    c, st, dev = run.c, run.state, run.device
    params = dict(ref.named_parameters())
    opt = AdamW(params, c, run.t["steps_per_epoch"])
    g = torch.Generator(device=dev).manual_seed(run.seed + 7)
    k = c["accumulation_steps"]
    losses, g1, flips = [], None, [0, 0]
    st["flips"] = flips
    for j in range(run.t["check_updates"] * k):
        b = st["pool"][j % len(st["pool"])]
        if half:
            b = _first_half(b)
        x = {key: torch.as_tensor(v, device=dev) for key, v in b.items()
             if key != "targets"}
        tg = {key: torch.as_tensor(v, device=dev)
              for key, v in b["targets"].items()}
        seq = {key: tg[key].long() if key.startswith("seq") else tg[key]
               for key in ("seq11", "seq12", "seq21", "seq22", "delta_x1",
                           "delta_x2", "delta_y1", "delta_y2")}
        with torch.autocast(dev.type, torch.bfloat16, enabled=autocast):
            classes, refs = ref(x["query_images"], x["support_coords"],
                                x["support_mask"], x["skeleton_edges"], seq,
                                g)
        classes, refs = classes.float(), refs.float()
        signs = None
        if prog_coords is not None:
            t = tg["target_seq"]
            signs = torch.sign(prog_coords[j] - t)
            sup = ((tg["token_labels"] == 0) & tg["visibility_mask"].bool())
            sup = sup[None, ..., None].expand_as(signs)
            flips[0] += int(((torch.sign(refs.detach() - t) != signs)
                             & sup).sum())
            flips[1] += int(sup.sum())
        terms = criterion(classes, refs, tg, c, signs)
        opt.step(grads_of(terms["total"], params))
        losses.append({k: float(v.detach()) for k, v in terms.items()})
        if j == k - 1:
            g1 = leaf_norms({n: opt.mu[n] / (1 - ADAM_B1) for n in params})
    return losses, g1, {n: p.detach() for n, p in params.items()}


def _first_half(tree):
    if isinstance(tree, dict):
        return {k: _first_half(v) for k, v in tree.items()}
    return tree[:len(tree) // 2]


def _gaps(run, losses, g1, after, ref_losses, ref_g1, ref_after):
    """The readings of a run against the reference's: the worst micro-step
    loss, and of the first clipped gradient and the change, the worst leaf
    and the median leaf (each leaf's gap over the larger of its reference
    norm and the median leaf's)."""
    w = run.weights
    names = list(ref_g1)
    med = sorted(ref_g1.values())[len(names) // 2]
    moved = [n for n in names if ref_g1[n] >= 1e-3 * med]
    change = leaf_norms({n: after[n] - w[n] for n in names})
    ref_change = leaf_norms({n: ref_after[n] - w[n] for n in names})
    terms = [abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(losses, ref_losses)
             for k in b if k != "total"]
    out = {"loss_gap": sum(terms) / len(terms),
           "total_loss_gap": max(abs(a["total"] - b["total"]) / abs(b["total"])
                                 for a, b in zip(losses, ref_losses)),
           "leaves_compared": len(moved)}
    for what, p, r, ns in (("grad", g1, ref_g1, names),
                           ("change", change, ref_change, moved)):
        gaps = leaf_gaps(p, r, ns)
        ranked = sorted(ns, key=lambda n: -gaps[n])
        out[what + "_gap"] = gaps[ranked[0]]
        out[what + "_gap_median"] = gaps[ranked[len(ranked) // 2]]
        run.log(f"{what}: worst leaves " + "; ".join(
            f"{n} {p[n]:.4g} vs {r[n]:.4g}" for n in ranked[:4]))
    return out


def check(run):
    st, c = run.state, run.c
    prog_g1 = leaf_norms({n: m / (1 - ADAM_B1)
                          for n, m in zip(st["names"], st["mu1"])})
    prog_after = dict(zip(st["names"], st["masters"]))
    ref = checks.reference(c, run.weights, run.device).train()
    ref_losses, ref_g1, ref_after = _follow(run, ref)
    out = _gaps(run, st["losses"], prog_g1, prog_after, ref_losses, ref_g1,
                ref_after)
    run.log("check: losses " + " ".join(
        f"{a['total']:.6g}/{b['total']:.6g}"
        for a, b in zip(st["losses"], ref_losses)))
    if run.control:
        del ref
        for name, qdtype, half in (("control", torch.float8_e4m3fn, False),
                                   ("half_batch", None, True)):
            q = checks.reference(c, run.weights, run.device, qdtype).train()
            q_losses, q_g1, q_after = _follow(run, q, half)
            del q
            out[name] = _gaps(run, q_losses, q_g1, q_after, ref_losses,
                              ref_g1, ref_after)
        s = checks.reference(c, run.weights, run.device).train()
        s_losses, s_g1, s_after = _follow(run, s, prog_coords=st["coords"])
        del s
        run.log("signs: the reference with the program's L1 signs")
        out["signs"] = _gaps(run, st["losses"], prog_g1, prog_after,
                             s_losses, s_g1, s_after)
        out["signs"].update(flipped=st["flips"][0],
                            supervised=st["flips"][1])
        for name, autocast in (("loc_bf16", False), ("autocast_bf16", True)):
            s = checks.reference(c, run.weights, run.device).train()
            for m in s.modules():
                if isinstance(m, MSDeformAttn) and not autocast:
                    m.loc_dtype = torch.bfloat16
            w_losses, w_g1, w_after = _follow(run, s, autocast=autocast)
            del s
            run.log(f"{name}: against the plain reference")
            out[name] = _gaps(run, w_losses, w_g1, w_after, ref_losses,
                              ref_g1, ref_after)
    return out
