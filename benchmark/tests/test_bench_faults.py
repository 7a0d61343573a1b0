"""`correct` against broken programs, at the tiny size on the CPU: a run
drives the rest of the cell with the timed path broken underneath and
must come out not correct, once for each fault the cell can have; and the
control (the reference in float8 in the program's place) reads above the
program's readings."""

import time

import pytest

import harness
import tiny


def _run(cell, **kw):
    return harness.execute(cell, 2 ** 31 + 77, 0.01, False, "cpu",
                           time.perf_counter(), files=tiny.files(cell), **kw)


def _alter_decoded_token(monkeypatch):
    """A served coordinate moved where the decode produces it."""
    from cape_tpu_torch.models import cape
    real = cape.decode_outputs

    def altered(carry, seq_len):
        out = real(carry, seq_len)
        out["pred_coords"][0, 1] = (out["pred_coords"][0, 1] + 0.25) % 1.0
        return out

    monkeypatch.setattr(cape, "decode_outputs", altered)


def test_sound_runs_are_correct():
    for cell in ("cape-geo.serve-b8", "cape-legacy.eval-kpt",
                 "cape-geo.train-update"):
        assert _run(cell)["correct"], cell


@pytest.mark.parametrize("cell", ["cape-geo.serve-b8",
                                  "cape-legacy.eval-kpt"])
def test_altered_token_is_caught(monkeypatch, cell):
    _alter_decoded_token(monkeypatch)
    r = _run(cell)
    assert not r["correct"]
    assert r["checks"]["coords_gap"]["value"] > \
        r["checks"]["coords_gap"]["limit"]


def test_altered_score_is_caught(monkeypatch):
    from cape_tpu_torch.eval import pck
    real = pck.PCKEvaluator.add_sample

    def drop_a_keypoint(self, pred, gt, *a, visibility=None, **k):
        vis = None if visibility is None else visibility.copy()
        if vis is not None and vis.any():
            vis[vis.argmax()] = 0
        return real(self, pred, gt, *a, visibility=vis, **k)

    monkeypatch.setattr(pck.PCKEvaluator, "add_sample", drop_a_keypoint)
    r = _run("cape-legacy.eval-kpt")
    assert not r["correct"]
    assert r["checks"]["pck_count_gap"]["value"] > 0


def test_state_left_unchanged_is_caught(monkeypatch):
    from cape_tpu_torch.train import state
    monkeypatch.setattr(state.FusedAdamW, "apply",
                        lambda self, st, params: None)
    r = _run("cape-geo.train-update")
    assert not r["correct"]
    assert r["checks"]["change_gap_median"]["value"] == pytest.approx(1.0)


def test_half_batch_is_caught(monkeypatch):
    from cape_tpu_torch.train import train_step
    real = train_step.forward_losses

    def half(model, cfg, batch, *a, **k):
        def cut(t):
            return {n: cut(v) for n, v in t.items()} if isinstance(t, dict) \
                else t[:len(t) // 2]
        return real(model, cfg, cut(batch), *a, **k)

    monkeypatch.setattr(train_step, "forward_losses", half)
    r = _run("cape-geo.train-update")
    assert not r["correct"]
    assert r["checks"]["loss_gap"]["value"] > r["checks"]["loss_gap"]["limit"]


@pytest.mark.parametrize("cell", ["cape-geo.serve-b8", "cape-legacy.eval-kpt",
                                  "cape-geo.train-update"])
def test_control_reads_above_the_program(cell):
    """At the tiny size the program runs in bf16, as the cells state; the
    control reads at least three times its worst reading in one number,
    and the harness judges the control, and each fault it runs, not
    correct against the cell's limits while the program is correct."""
    f = tiny.files(cell, bf16=True)
    r = harness.execute(cell, 2 ** 31 + 78, 0.01, False, "cpu",
                        time.perf_counter(), files=f, control=True)
    prog, ctl = r["readings"], r["control"]["control"]
    names = [n for n in r["checks"] if n in ctl]
    assert max(ctl[n] / max(prog[n], 1e-12) for n in names) >= 3, (prog, ctl)
    assert r["correct"], r["checks"]
    assert set(r["control_verdicts"]) == set(r["control"])
    for name, v in r["control_verdicts"].items():
        assert not v["correct"], (name, v["checks"])
        assert set(v["checks"]) <= set(r["checks"])
