"""Whole runs of the harness at tiny sizes on the CPU: the drivers against
the reference, the refusal without a card, and planted faults that the
check has to catch. Tests that need the card carry the `cuda` marker."""

import json

import pytest
import torch

import run
import tiny

SEED = 3_000_000_019  # over 2**31, as the driver's seeds are


def one_run(capsys, workload, override, seconds=2.0, **kw):
    rc = run.main(["--workload", workload, "--seed", str(SEED), "--seconds", str(seconds),
                   "--trace", "0"], need_card=False, device="cpu", override=override, **kw)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.mark.parametrize("workload,override", [("sortformer_offline", tiny.tiny_sortformer)])
def test_driver_agrees_with_reference(capsys, workload, override):
    res = one_run(capsys, workload, override)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["extra"]["completed"] >= 1
    assert list(res)[-1] == "checks"
    assert all(v["value"] <= v["limit"] for v in res["checks"].values())


def test_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "sortformer_offline", "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


# ------------------------------------------------------------------ faults


def half_batch_left_out(driver):
    """The encoder leaves out the second half of the batch's rows."""
    fn = driver.enc_probe.fn

    def broken(mel, lengths, *a, **kw):
        x, n = fn(mel, lengths, *a, **kw)
        x = x.clone()
        x[x.shape[0] // 2:] = 0
        return x, n

    driver.enc_probe.fn = broken


def altered_probabilities(driver):
    """The diarizer's speaker probabilities altered where the head makes them."""
    model = driver.diarizer.model
    fwd = model.forward

    def broken(mel):
        p = fwd(mel)
        return torch.clamp(p + 0.05, max=1.0)

    model.forward = broken


@pytest.mark.parametrize("workload,override,fault", [
    ("sortformer_offline", tiny.tiny_sortformer, altered_probabilities),
    ("sortformer_offline", tiny.tiny_sortformer, half_batch_left_out),
], ids=lambda x: getattr(x, "__name__", x) if callable(x) else x)
def test_planted_fault_fails_the_check(capsys, workload, override, fault):
    undo = []
    res = one_run(capsys, workload, override, fault=lambda d: undo.append(fault(d)))
    for u in undo:
        if callable(u):
            u()
    assert not res["correct"], res["checks"]


# ----------------------------------------------------------------- readers


def test_metric_readers_read_by_name():
    """Readers find what they read in the run's dicts by name, and return
    nothing where there is nothing to read."""
    empty = run.Run()
    for name in ("attn_roofline.diar", "mfu.diar", "encoder_ms_per_min.diar",
                 "head_ms_per_min.diar", "idle_share.diar"):
        reader = run.load_module(run.BENCH / "metrics" / f"{name}.py", "metric_" + name)
        assert reader.read(empty) is None, name
    r = run.Run()
    # two calls of 2 rows of 100 keys (a third, padding, row left out), H 8, Dh 64
    call = {"lengths": torch.tensor([100, 100, 100]), "rows": 2, "heads": 8, "head_dim": 64,
            "in": "float32", "out": "float32"}
    r.calls = {"attention": [(1e-3, call), (3e-3, call)]}
    from yardstick.costs import attention_cost, bound_s
    nbytes, ops = attention_cost([100, 100], 8, 64, "float32", "float32")
    reader = run.load_module(run.BENCH / "metrics" / "attn_roofline.diar.py", "metric_attn")
    assert reader.read(r) == pytest.approx(100 * 2 * bound_s(nbytes, ops, "float32") / 4e-3)
    r.tally, r.part_s, r.dtype = {"flops": 67e12}, 2.0, "float32"
    reader = run.load_module(run.BENCH / "metrics" / "mfu.diar.py", "metric_mfu")
    assert reader.read(r) == pytest.approx(50.0)


# ----------------------------------------------------------------- control


@pytest.mark.cuda
def test_sortformer_control_fails_on_the_card(capsys):
    """TF32, the Sortformer control, fails the check on the card (TF32 does
    not exist on the CPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    rc = run.main(["--workload", "sortformer_offline", "--seed", str(SEED), "--seconds", "2",
                   "--trace", "0"], device="cuda", override=tiny.tiny_sortformer, control=True)
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and not res["correct"]
