"""The port's spans (``tpukube_torch/obs/spans.py``): off and empty outside
a profiler; inside one, a forward's and a train step's spans nested by
parent id beside the profiler's own ranges of the same names; one file a
process at exit, read back by ``trace.load`` and drawn by the merged
timeline; and the benchmark's four readers of them on synthetic pods.

The test marked ``card`` needs CUDA and skips without it; on the card:
``python -m pytest tests/test_torch_spans.py -m card --noconftest``."""

import json
import os
import subprocess
import sys
import textwrap
import time
from types import SimpleNamespace

import pytest
import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from kubebench import run
from kubebench.manifest import load_part
from tpukube_torch import trace
from tpukube_torch.graft import free_port
from tpukube_torch.obs import spans, timeline
from tpukube_torch.workload import llama, mla_moe, resnet, train
from tpukube_torch.workload.meshenv import build_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = llama.LlamaConfig(vocab=64, d_model=32, n_layers=3, n_heads=4, n_kv_heads=2,
                        d_ff=64, max_seq=32)
RES = resnet.ResNetConfig(num_classes=10, width=8, stage_blocks=(1, 1), groups=4, image_size=8)


@pytest.fixture(autouse=True)
def empty_recorder():
    spans.RECORDER.drain()
    yield
    spans.RECORDER.drain()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip (see the module's docstring)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def mesh():
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        yield build_mesh("cpu", 1, 1)
    finally:
        dist.destroy_process_group()


def _tiny(device=torch.device("cpu")):
    params = llama.init_params(torch.Generator(device).manual_seed(0), CFG, device)
    tokens = torch.randint(0, CFG.vocab, (1, 12), generator=torch.Generator().manual_seed(1))
    return params, tokens.to(device)


def _by_name(recorded):
    out = {}
    for s in recorded:
        out.setdefault(s["name"], []).append(s)
    return out


def test_off_outside_a_profiler_records_nothing():
    params, tokens = _tiny()
    first = spans.span("tpukube.forward", tokens)
    assert first is spans.OFF and spans.span("tpukube.step") is first
    with first:
        pass
    llama.forward(params, tokens, CFG)
    assert spans.RECORDER.drain() == []


def test_forward_records_its_attention_spans_nested_in_the_profilers_trace():
    params, tokens = _tiny()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        llama.forward(params, tokens, CFG)
    got = _by_name(spans.RECORDER.drain())
    assert sorted(got) == ["tpukube.attention", "tpukube.forward"]
    (fwd,), att = got["tpukube.forward"], got["tpukube.attention"]
    assert len(att) == CFG.n_layers
    assert fwd["parent"] is None and fwd["root"] == fwd["id"]
    for s in att:
        assert s["parent"] == s["root"] == fwd["id"]
        assert fwd["t0"] <= s["t0"] < s["t1"] <= fwd["t1"] and s["device_ms"] > 0
    annotations = [e.name() for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation() and e.device_type() == DeviceType.CPU]
    assert annotations.count("tpukube.forward") == 1
    assert annotations.count("tpukube.attention") == CFG.n_layers


MOE = mla_moe.MlaMoeConfig(vocab=64, d_model=32, n_layers=3, n_heads=2, kv_rank=16, qk_nope_dim=8,
                           qk_rope_dim=8, v_dim=8, d_ff_dense=64, n_experts=4, top_k=2, d_expert=16)


def test_moe_forward_records_attention_and_moe_spans_as_the_forwards_children():
    params = mla_moe.init_params(torch.Generator().manual_seed(0), MOE, torch.device("cpu"))
    tokens = torch.randint(0, MOE.vocab, (1, 10), generator=torch.Generator().manual_seed(1))
    with profile(activities=[ProfilerActivity.CPU]):
        mla_moe.forward(params, tokens, MOE)
    got = _by_name(spans.RECORDER.drain())
    assert sorted(got) == ["tpukube.attention", "tpukube.forward", "tpukube.moe"]
    (fwd,) = got["tpukube.forward"]
    assert len(got["tpukube.attention"]) == MOE.n_layers and len(got["tpukube.moe"]) == MOE.n_moe
    for s in got["tpukube.attention"] + got["tpukube.moe"]:
        assert s["parent"] == fwd["id"] and fwd["t0"] <= s["t0"] < s["t1"] <= fwd["t1"]
    for s in got["tpukube.moe"]:
        rows = s["counts"]["rows_per_expert"]
        assert len(rows) == MOE.n_experts and sum(rows) == 10 * MOE.top_k
    assert all("counts" not in s for s in got["tpukube.attention"] + [fwd])


class _Watched(torch.Tensor):
    """A tensor that logs every torch function applied to it."""

    calls: list = []

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        cls.calls.append(getattr(func, "__name__", str(func)))
        return super().__torch_function__(func, types, args, kwargs or {})


def test_a_span_counter_is_read_only_at_export():
    rows = torch.tensor([3, 0, 5]).as_subclass(_Watched)
    _Watched.calls.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("tpukube.moe") as s:
            s.count("rows_per_expert", rows)
            assert _Watched.calls == []  # nothing read, so nothing waits for the device
    assert _Watched.calls == []
    (done,) = spans.RECORDER.drain()
    assert done["counts"] == {"rows_per_expert": [3, 0, 5]}
    assert "tolist" in _Watched.calls


def test_the_no_op_span_takes_a_counter_and_keeps_nothing():
    rows = torch.tensor([1, 2]).as_subclass(_Watched)
    _Watched.calls.clear()
    with spans.span("tpukube.moe", rows) as s:
        assert s is spans.OFF
        s.count("rows_per_expert", rows)
    assert spans.RECORDER.drain() == [] and _Watched.calls == []


def test_decoder_train_step_records_its_phases_in_order(mesh):
    params, _ = _tiny()
    for leaf in llama.tree_leaves(params):
        leaf[1].requires_grad_(True)
    step, init = train.make_train_step(CFG, mesh, remat=False)
    state = init(params)
    tokens = torch.randint(0, CFG.vocab, (2, 9), generator=torch.Generator().manual_seed(2))
    with profile(activities=[ProfilerActivity.CPU]):
        step(params, state, tokens)
    recorded = spans.RECORDER.drain()
    outer = [s for s in recorded if s["name"] != "tpukube.attention"]
    assert [s["name"] for s in outer] == ["tpukube.step", "tpukube.grads",
                                          "tpukube.grad_norm", "tpukube.update"]
    root = outer[0]["id"]
    assert all(s["parent"] == root for s in outer[1:])
    assert all(a["t1"] <= b["t0"] for a, b in zip(outer[1:], outer[2:]))
    grads = outer[1]["id"]
    assert [s["parent"] for s in recorded if s["name"] == "tpukube.attention"] == [grads] * CFG.n_layers


def test_resnet_step_records_grads_then_update(mesh):
    params = resnet.init_params(torch.Generator().manual_seed(0), RES, torch.device("cpu"))
    step = resnet.make_dp_train_step(RES, mesh, learning_rate=0.01)
    images = torch.randn(2, RES.image_size, RES.image_size, 3, generator=torch.Generator().manual_seed(3))
    labels = torch.tensor([1, 2])
    with profile(activities=[ProfilerActivity.CPU]):
        step(params, images, labels)
    recorded = spans.RECORDER.drain()
    assert [s["name"] for s in recorded] == ["tpukube.step", "tpukube.grads", "tpukube.update"]
    assert [s["parent"] for s in recorded] == [None, recorded[0]["id"], recorded[0]["id"]]


def test_a_profiled_process_leaves_one_file_that_loads_and_draws(tmp_path):
    child = textwrap.dedent(f"""
        import torch
        from torch.profiler import profile, ProfilerActivity
        from tpukube_torch.workload import llama
        cfg = llama.{CFG!r}
        params = llama.init_params(torch.Generator().manual_seed(0), cfg, torch.device("cpu"))
        llama.forward(params, torch.zeros(1, 5, dtype=torch.long), cfg)  # not profiled
        with profile(activities=[ProfilerActivity.CPU]):
            llama.forward(params, torch.zeros(1, 7, dtype=torch.long), cfg)
    """)
    env = {**os.environ, "TMPDIR": str(tmp_path), "PYTHONPATH": REPO}
    subprocess.run([sys.executable, "-c", child], env=env, check=True, timeout=300)
    files = os.listdir(tmp_path / "tpukube_torch-spans")
    assert len(files) == 1 and files[0].startswith(spans.PREFIX)
    events = trace.load(str(tmp_path / "tpukube_torch-spans" / files[0]))
    assert [e["kind"] for e in events] == ["span"] * (1 + CFG.n_layers)
    assert [e["request"]["name"] for e in events] == ["tpukube.forward"] + ["tpukube.attention"] * CFG.n_layers
    drawn = [e for e in timeline.merged_chrome_trace([("pod", events)])["traceEvents"]
             if e["ph"] == "X"]
    fwd = next(e for e in drawn if e["name"] == "tpukube.forward")
    req = events[0]["request"]
    assert fwd["ts"] == 0 and fwd["dur"] == pytest.approx((req["t1"] - req["t0"]) * 1e6, abs=1e-2)
    for e in drawn:
        if e["name"] == "tpukube.attention":
            assert fwd["ts"] <= e["ts"] and e["ts"] + e["dur"] <= fwd["ts"] + fwd["dur"]
            assert e["args"]["parent"] == req["id"]


def test_the_directory_keeps_the_newest_files(tmp_path):
    old = time.time() - 3600
    for i in range(spans.FILES_KEPT + 5):
        path = tmp_path / f"{spans.PREFIX}{i}-0.jsonl"
        path.write_text("")
        os.utime(path, (old + i, old + i))
    (tmp_path / "other.jsonl").write_text("")
    params, tokens = _tiny()
    with profile(activities=[ProfilerActivity.CPU]):
        llama.forward(params, tokens, CFG)
    newest = spans.RECORDER.export(str(tmp_path))
    left = sorted(os.listdir(tmp_path))
    assert len(left) == spans.FILES_KEPT + 1 and "other.jsonl" in left
    assert os.path.basename(newest) in left
    assert f"{spans.PREFIX}0-0.jsonl" not in left and f"{spans.PREFIX}5-0.jsonl" not in left
    assert f"{spans.PREFIX}6-0.jsonl" in left
    assert spans.RECORDER.export(str(tmp_path)) is None


# the benchmark's readers, on pods made up here: slices and kernel
# intervals in realtime ns, as the pod's summary reports them, and span
# files as the program writes them

S0 = 1_700_000_000_000_000_000
MS = 1_000_000


def _pod(slice_ms, busy_ms):
    return {"trace": {"slice": [S0 + slice_ms[0] * MS, S0 + slice_ms[1] * MS],
                      "busy": [[S0 + a * MS, S0 + b * MS] for a, b in busy_ms],
                      "by_name": {}, "dense_by_op": {}, "gaps": [], "units": []}}


def _ctx(*pods):
    reports = list(pods)
    return SimpleNamespace(reports=reports, trace=run.merge_traces(reports))


def _write(directory, name, recorded):
    """A span file: (name, t0 ms, t1 ms, device_ms, id, parent) each."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, f"{spans.PREFIX}{name}.jsonl"), "w") as f:
        for seq, (n, t0, t1, dev, i, parent) in enumerate(recorded, start=1):
            req = {"name": n, "t0": (S0 + t0 * MS) / 1e9, "t1": (S0 + t1 * MS) / 1e9,
                   "device_ms": dev, "id": i, "parent": parent, "root": parent or i}
            f.write(json.dumps({"seq": seq, "ts": req["t1"], "kind": "span",
                                "request": req, "response": None}) + "\n")


@pytest.fixture
def span_dir(tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return spans.default_dir()


def _read(metric, ctx):
    return load_part("metrics", metric).read(ctx)


# a slice of 100 ms: two forwards (10-40, 55-90); kernels leave idle
# 0-12 (starts before any forward), 20-25 and 30-32 (inside the first),
# 45-60 (between), 70-71 (inside the second) and 95-100 (between)
BUSY = [(12, 20), (25, 30), (32, 45), (60, 70), (71, 95)]
FORWARDS = [("tpukube.forward", 10, 40, 35.0, 1, None), ("tpukube.attention", 12, 20, 14.0, 2, 1),
            ("tpukube.forward", 55, 90, 40.0, 3, None), ("tpukube.attention", 60, 70, 16.0, 4, 3),
            ("tpukube.attention", 91, 92, 99.0, 5, None)]


def test_idle_split_sums_to_the_idle_share(span_dir):
    _write(span_dir, "pod", FORWARDS)
    ctx = _ctx(_pod((0, 100), BUSY))
    inside = _read("idle_in_forward_pct.prefill", ctx)
    between = _read("idle_between_forwards_pct.prefill", ctx)
    assert inside == pytest.approx(5 + 2 + 1)
    assert between == pytest.approx(12 + 15 + 5)
    assert inside + between == pytest.approx(_read("idle_pct.prefill", ctx), abs=1e-9)


def test_attention_share_counts_the_forwards_children(span_dir):
    _write(span_dir, "pod", FORWARDS)
    # the orphan attention span (parent None) is no forward's
    assert _read("attention_share.prefill", _ctx(_pod((0, 100), BUSY))) == pytest.approx(
        (14 + 16) / (35 + 40) * 100)


@pytest.mark.parametrize("recorded,share", [
    # the decoder: grads, the clip's norm, the update
    ([("tpukube.step", 0, 50, 50.0, 1, None), ("tpukube.grads", 1, 40, 42.0, 2, 1),
      ("tpukube.grad_norm", 40, 41, 2.0, 3, 1), ("tpukube.update", 41, 49, 6.0, 4, 1),
      ("tpukube.attention", 5, 6, 1.0, 5, 2)], (2 + 6) / 50 * 100),
    # the ResNet: grads, then the all-reduce and SGD
    ([("tpukube.step", 0, 40, 40.0, 1, None), ("tpukube.grads", 1, 30, 38.0, 2, 1),
      ("tpukube.update", 30, 39, 1.0, 3, 1), ("tpukube.step", 45, 85, 40.0, 4, None),
      ("tpukube.grads", 46, 75, 37.0, 5, 4), ("tpukube.update", 75, 84, 3.0, 6, 4)],
     (1 + 3) / 80 * 100),
])
def test_optimizer_share_over_the_steps(span_dir, recorded, share):
    _write(span_dir, "pod", recorded)
    assert _read("optimizer_share.train", _ctx(_pod((0, 100), BUSY))) == pytest.approx(share)


READERS = ["idle_in_forward_pct.prefill", "idle_between_forwards_pct.prefill",
           "attention_share.prefill", "optimizer_share.train"]


@pytest.mark.parametrize("metric", READERS)
def test_a_reader_finds_nothing_without_the_pods_file(span_dir, metric):
    steps = [("tpukube.step", 0, 50, 50.0, 1, None), ("tpukube.update", 41, 49, 6.0, 2, 1)]
    ctx = _ctx(_pod((0, 100), BUSY))
    assert _read(metric, ctx) is None  # no directory
    # a file from another slice: a run a second later
    _write(span_dir, "later", [(n, t0 + 1000, t1 + 1000, d, i, p) for n, t0, t1, d, i, p in FORWARDS + steps])
    assert _read(metric, ctx) is None
    # two files inside one pod's slice
    _write(span_dir, "a", FORWARDS + [(n, t0, t1, d, i + 10, p and p + 10) for n, t0, t1, d, i, p in steps])
    _write(span_dir, "b", FORWARDS + [(n, t0, t1, d, i + 10, p and p + 10) for n, t0, t1, d, i, p in steps])
    assert _read(metric, ctx) is None
    os.remove(os.path.join(span_dir, f"{spans.PREFIX}b.jsonl"))
    assert _read(metric, ctx) is not None
    # an untraced run, or a program that records no spans
    assert _read(metric, SimpleNamespace(reports=[{"trace": None}], trace=None)) is None
    reader = load_part("metrics", metric)
    if hasattr(reader, "files_for"):
        reader.files_for = None
        assert reader.read(ctx) is None


@pytest.mark.card
def test_a_forward_span_is_on_the_profilers_clock(cuda):
    params, tokens = _tiny(cuda)
    tokens = torch.randint(0, CFG.vocab, (1, 32), device=cuda)
    llama.forward(params, tokens, CFG)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            llama.forward(params, tokens, CFG)
            torch.cuda.synchronize()
    recorded = _by_name(spans.RECORDER.drain())["tpukube.forward"]
    ranges = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                    if e.name() == "tpukube.forward" and e.device_type() == DeviceType.CPU)
    assert len(recorded) == len(ranges) == 5
    # the first range of a profiling session pays the profiler's warm-up
    for s, (a, b) in list(zip(recorded, ranges))[1:]:
        assert abs(s["t0"] * 1e9 - a) < 50_000 and abs(s["t1"] * 1e9 - b) < 50_000
        assert 0 < s["device_ms"]
