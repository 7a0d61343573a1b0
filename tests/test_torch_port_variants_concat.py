"""Parity of the port's concat-src decoder family with the JAX package on
the CPU, at the tiny config in fp32 with dropout 0: the whole model
teacher-forced under v4, v41, v5 and v6 (each with
`dec_attn_concat_src`) and under v1 with `dec_attn_concat_src`, one AdamW
update of v4 (whose own `sampling_offsets` belong to the `offsets`
group) and its JAX train state carried over.

The whole-model checks are `test_torch_port_util`'s (`variant_tiny`,
`variant_runs`); `test_torch_port_variants.py` holds the layers and the
other configs.
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from cape_tpu.train import state as jax_state

from cape_tpu_torch.config import CAPEConfig as PortConfig
from cape_tpu_torch.convert import from_jax_params, from_jax_train_state
from cape_tpu_torch.train import state as port_state

from test_torch_port_util import (assert_variant_gradients,
                                  assert_variant_labels,
                                  assert_variant_outputs, port_model,
                                  variant_runs, variant_tiny)

MODEL_CONFIGS = ["v4", "v41", "v5", "v6", "v1_concat_src"]
STEPS_PER_EPOCH = 4


@pytest.mark.parametrize("name", MODEL_CONFIGS)
def test_teacher_forced_outputs_match_jax(name):
    assert_variant_outputs(name)


@pytest.mark.parametrize("name", MODEL_CONFIGS)
def test_every_parameter_gradient_matches_jax(name):
    assert_variant_gradients(name)


@pytest.mark.parametrize("name", MODEL_CONFIGS)
def test_param_labels_match_jax(name):
    assert_variant_labels(name)


@pytest.fixture(scope="module")
def v4_update():
    """One AdamW update of v4 in both packages from the same (JAX)
    gradients, in a warmup so that the groups' lrs differ."""
    import optax

    cfg, _, params = variant_tiny("v4")
    cfg = cfg.replace(warmup_epochs=1)
    grads = variant_runs("v4")["jax_grads"]
    tx = jax_state.make_optimizer(cfg, STEPS_PER_EPOCH)

    @jax.jit
    def update(params, grads):
        opt = tx.init(params)
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), opt

    new, opt = jax.device_get(update(params, grads))
    pcfg = PortConfig.from_json(cfg.to_json())
    pm = port_model(cfg, params)
    st = port_state.create_train_state(pcfg, pm, STEPS_PER_EPOCH)
    before = {n: p.detach().clone() for n, p in pm.named_parameters()}
    flat = from_jax_params(grads, pcfg)
    assert st.tx.update([flat[n] for n in st.opt_state.names], st.opt_state,
                        [p for _, p in pm.named_parameters()])
    jstate = jax_state.TrainState(step=jnp.ones((), jnp.int32), params=new,
                                  opt_state=opt)
    return pcfg, pm, st, before, flat, from_jax_params(new, pcfg), jstate


def test_v4_adamw_update_matches_jax(v4_update):
    """Every parameter's update in units of its group's lr: within 1e-4
    plus two fp32 spacings of the parameter (each package rounds its own
    sum p + u), or 0.1 where Adam's first step g / (|g| + eps) amplifies
    fp32 noise: where the clipped gradient is within 100 eps of zero, as
    in `test_torch_port_train`'s update check."""
    pcfg, pm, st, before, grads, want, _ = v4_update
    lrs = st.tx.group_lrs(0)
    assert lrs["offsets"] != lrs["base"]
    labels = dict(zip(st.opt_state.names, st.opt_state.labels))
    assert labels["decoder.layers.1.sampling_offsets.weight"] == "offsets"
    assert labels["decoder.layers.1.source_proj.weight"] == "base"
    norm = np.sqrt(sum((g.double() ** 2).sum().item() for g in grads.values()))
    clip = min(1.0, pcfg.clip_max_norm / norm)
    for n, p in pm.named_parameters():
        lr = lrs[labels[n]]
        if lr == 0.0:
            assert torch.equal(p.detach(), before[n]), n
            continue
        got = ((p.detach() - before[n]) / lr).numpy()
        exp = ((want[n] - before[n]) / lr).numpy()
        ulps = 2 * np.spacing(np.abs(want[n].numpy())) / lr
        small = (grads[n].abs() * clip < 100 * port_state.ADAM_EPS).numpy()
        tol = np.where(small, 0.1, 1e-4 + ulps)
        bad = np.abs(got - exp) > tol
        assert not bad.any(), (n, np.abs(got - exp)[bad][:5], tol[bad][:5])


def test_v4_train_state_carry_over(v4_update):
    """`from_jax_train_state` of the JAX state after the update: its
    counts, and the parameters and Adam moments the port computed."""
    pcfg, _, st, _, _, _, jstate = v4_update
    sd = from_jax_train_state(flax.serialization.to_state_dict(
        jax.device_get(jstate)), pcfg)
    assert (sd["step"], sd["adam_count"], sd["sched_count"]) == (1, 1, 1)
    for key, mine in (("params", st.opt_state.masters),
                      ("mu", st.opt_state.mu), ("nu", st.opt_state.nu)):
        for n, m in zip(st.opt_state.names, mine):
            torch.testing.assert_close(sd[key][n], m, atol=1e-6, rtol=1e-4,
                                       msg=f"{key} {n}")
