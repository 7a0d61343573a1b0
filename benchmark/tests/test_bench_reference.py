"""The plain reference against the program at the program's test size on
the CPU, on the benchmark's seeded weights: the teacher-forced forward of
both support encoders, the loss and every gradient, and the optimizer's
updates."""

import math

import numpy as np
import pytest
import torch

import check as checks
import common
import tiny
import traffic
from reference.model import RefCAPE
from reference.train import AdamW, criterion, grads_of

SEQ = ("seq11", "seq12", "seq21", "seq22", "delta_x1", "delta_x2",
       "delta_y1", "delta_y2")


def _setup(cell, **over):
    f = tiny.files(cell, **over)
    c = f["config"]["cape"]
    init = dict(f["config"]["assumed"]["init"], **f["traffic"]["init"])
    w = common.make_weights(checks.param_shapes(c), c, init, 2 ** 33 + 5,
                            "cpu")
    from cape_tpu_torch.config import CAPEConfig
    from cape_tpu_torch.models.cape import CAPE
    cfg = CAPEConfig.from_json(common.json.dumps(c))
    model = CAPE(cfg, device="cpu")
    model.load_state_dict(w)
    ref = checks.reference(c, w, "cpu")
    t = dict(f["traffic"], kind="train", episodes=1, queries=2, pool=2,
             keypoints=[[3, 1], [5, 1]], jitter=0.03, unlabeled=0.1,
             block=8)
    batch = traffic.train(t, c, 7)[0]
    return c, cfg, w, model, ref, batch


def _tensors(b):
    return {k: (_tensors(v) if isinstance(v, dict) else torch.as_tensor(v))
            for k, v in b.items()}


@pytest.mark.parametrize("cell", ["cape-geo.train-update",
                                  "cape-legacy.eval-kpt"])
def test_forward_matches_program(cell):
    c, cfg, w, model, ref, b = _setup(cell)
    b = _tensors(b)
    with torch.no_grad():
        out = model(b["query_images"], b["support_coords"],
                    b["support_mask"], b["skeleton_edges"], b["targets"])
        seq = {k: b["targets"][k].long() if k.startswith("seq")
               else b["targets"][k] for k in SEQ}
        cls, refs = ref(b["query_images"], b["support_coords"],
                        b["support_mask"], b["skeleton_edges"], seq)
    torch.testing.assert_close(cls[-1], out["pred_logits"], atol=2e-5,
                               rtol=1e-4)
    torch.testing.assert_close(refs[-1], out["pred_coords"], atol=2e-5,
                               rtol=1e-4)
    torch.testing.assert_close(cls[:-1], out["aux_classes"], atol=2e-5,
                               rtol=1e-4)


def test_loss_gradients_and_updates_match_program():
    from cape_tpu_torch.train import create_train_state, make_train_step
    c, cfg, w, model, ref, b = _setup("cape-geo.train-update")
    state = create_train_state(cfg, model, 10, masters=w)
    step = make_train_step(model, cfg, 10)
    params = dict(ref.named_parameters())
    opt = AdamW(params, c, 10)
    for _ in range(2 * c["accumulation_steps"]):
        _, m = step(state, b, None)
        bt = _tensors(b)
        seq = {k: bt["targets"][k].long() if k.startswith("seq")
               else bt["targets"][k] for k in SEQ}
        cls, refs = ref(bt["query_images"], bt["support_coords"],
                        bt["support_mask"], bt["skeleton_edges"], seq)
        terms = criterion(cls, refs, bt["targets"], c)
        for k, v in terms.items():
            assert math.isclose(float(m[k]), float(v.detach()),
                                rel_tol=1e-5), k
        loss = terms["total"]
        opt.step(grads_of(loss, params))
    st = state.opt_state
    norms = {n: float(torch.linalg.vector_norm(opt.mu[n])) for n in params}
    med = sorted(norms.values())[len(norms) // 2]
    for n, master, mu in zip(st.names, st.masters, st.mu):
        gap = float(torch.linalg.vector_norm(mu - opt.mu[n]))
        assert gap <= 1e-3 * float(torch.linalg.vector_norm(opt.mu[n])) \
            + 1e-8, n
        # Adam moves an element by ~lr whatever its gradient's size, so
        # elements of nearly no gradient part by a share of one step: the
        # change is compared leaf by leaf, over leaves with a gradient (a
        # key's bias under softmax has none and moves by round-off alone)
        if norms[n] < 1e-3 * med:
            continue
        mine = master - w[n]
        theirs = params[n].detach() - w[n]
        gap = float(torch.linalg.vector_norm(mine - theirs))
        assert gap <= 1e-2 * float(torch.linalg.vector_norm(theirs)), n


def test_fp8_control_rounds_linear_inputs():
    c = tiny.files("cape-geo.serve-b8")["config"]["cape"]
    q = RefCAPE(c, torch.float8_e4m3fn)
    lin = q.decoder.pos_trans
    x = torch.randn(3, c["hidden_dim"])
    exact = torch.nn.functional.linear(x, lin.weight, lin.bias)
    got = lin(x)
    assert 0 < float((got - exact).abs().max()) < 0.5
    assert np.isfinite(got.detach().numpy()).all()
