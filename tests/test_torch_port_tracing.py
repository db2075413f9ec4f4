"""The port's spans and counters (mopoe_mimic_tpu_torch/utils/profiling.py)
and the benchmark's readers of them (bench_port/metrics/_spans.py), on the
CPU at small width (64 px, DIM 2, class_dim 4, vocab 50, batch 8, float32).

* A ``run_epochs`` of 2 epochs on a CPU store with ``scan_epochs``: every
  span once a pass, in order, under its parent, with the epoch's number;
  the history's seconds are the spans' durations; one read a pass.
* The ring is bounded; under ``torch.profiler`` a span is a host event of
  its name around the work inside it.
* A replay counts the launches its capture made (a stand-in graph).
* The alignment of spans to a profile finds a planted offset and a planted
  idle stretch; the readers give None without a profile.
"""

import importlib.util
import sys
from pathlib import Path

import pytest
import torch

from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.experiment import Experiment
from mopoe_mimic_tpu_torch.ops import _build, cuda_fusion, cuda_texthead
from mopoe_mimic_tpu_torch.train import scan
from mopoe_mimic_tpu_torch.train.loop import run_epochs
from mopoe_mimic_tpu_torch.utils import profiling

BENCH_DIR = Path(__file__).resolve().parent.parent / "bench_port"
READERS = ("setup.store_s", "setup.capture_s", "loop.idle_ms")

PASS = ["epoch.index_matrix", "scan.upload", "scan.replays", "scan.read_means",
        "loop.nan_check", "loop.tb_write"]
# (name, parent's name) in the order the spans start
EPOCH_0 = ([("loop.epoch", None), ("loop.train_pass", "loop.epoch")]
           + [(n, "loop.train_pass") for n in PASS] + [("loop.test_pass", "loop.epoch")]
           + [(n, "loop.test_pass") for n in PASS] + [("loop.callbacks", "loop.epoch")]
           + [("loop.csv", "loop.callbacks"), ("callbacks.update", "loop.callbacks"),
              ("loop.csv", "callbacks.update"), ("checkpoint.stage", "callbacks.update"),
              ("loop.preemption_read", "loop.callbacks")])
# the last epoch: the eval round, then the staged best and this epoch written
EPOCH_1 = (EPOCH_0[:15] + [("eval.round", "loop.epoch"), ("eval.plots_collect", "eval.round"),
                           ("eval.plots_render", "eval.round")]
           + EPOCH_0[15:19] + [("checkpoint.write", "callbacks.update")] * 2 + EPOCH_0[20:])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Two epochs of two steps on a CPU store; (history, the run's spans,
    the counters' change)."""
    cfg = MopoeConfig(method="joint_elbo", dataset="testing", batch_size=8, class_dim=4,
                      DIM_img=2, DIM_text=2, img_size=64, text_encoding="word", vocab_size=50,
                      compute_dtype="float32", end_epoch=2, steps_per_training_epoch=2,
                      eval_freq=10, checkpoint_freq=1000, async_plots=False,
                      device_resident_data=True, scan_epochs=True, seed=3,
                      dir_experiment=str(tmp_path_factory.mktemp("tracing")))
    counters = dict(profiling.COUNTERS)
    first = max((s.id for s in profiling.spans()), default=0)
    result = run_epochs(Experiment(cfg, device="cpu"), preemption=None, device="cpu")
    spans = sorted((s for s in profiling.spans() if s.id > first), key=lambda s: s.start_ns)
    added = {k: v - counters.get(k, 0) for k, v in profiling.COUNTERS.items()}
    return result["history"], spans, added


@pytest.mark.parametrize("epoch, expected", [(0, EPOCH_0), (1, EPOCH_1)])
def test_an_epoch_records_its_spans_in_order(run, epoch, expected):
    _, spans, _ = run
    mine = [s for s in spans if s.epoch == epoch]
    by_id = {s.id: s for s in spans}
    got = [(s.name, by_id[s.parent].name if s.parent in by_id else None) for s in mine]
    assert got == expected
    for s in mine:
        assert s.start_ns <= s.end_ns
        if s.parent in by_id:
            parent = by_id[s.parent]
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
    replays = [s for s in mine if s.name == "scan.replays"]
    assert [s.attrs["kind"] for s in replays] == ["train", "eval"]
    for s in replays:
        stamps = s.attrs["stamps"]
        assert s.attrs["steps"] == len(stamps) == 2
        assert s.start_ns <= stamps[0] < stamps[1] <= s.end_ns


def test_set_up_spans_precede_the_epochs(run):
    _, spans, _ = run
    names = [s.name for s in spans if s.epoch is None]
    assert names == (["store.build", "store.fetch", "store.upload"] * 2
                     + ["state.init", "state.model", "state.optimizer"])
    builds = [s for s in spans if s.name == "store.build"]
    assert [s.attrs["rows"] for s in builds] == [16, 16] and all(s.attrs["bytes"] > 0
                                                                 for s in builds)


def test_history_seconds_are_the_spans(run):
    history, spans, _ = run
    for h in history:
        mine = {s.name: s for s in spans if s.epoch == h["epoch"]}
        writes = [s for s in spans if s.epoch == h["epoch"] and s.name == "checkpoint.write"]
        assert h["seconds"] == {
            "train": mine["loop.train_pass"].seconds, "test": mine["loop.test_pass"].seconds,
            "callbacks": mine["loop.callbacks"].seconds,
            "checkpoint": sum(s.end_ns - s.start_ns for s in writes) / 1e9}
    assert history[1]["seconds"]["checkpoint"] > 0


def test_one_read_a_pass(run):
    _, _, added = run
    assert added.get("scan.reads") == 4  # 2 epochs × (train + test)
    assert not any(k.startswith("scan.captures") for k in added)  # no graph on the CPU


def test_the_ring_is_bounded():
    first = profiling.span("tracing.first")
    with first:
        pass
    for _ in range(profiling.RING_SPANS):
        with profiling.span("tracing.filler"):
            pass
    ring = profiling.spans()
    assert len(ring) == profiling.RING_SPANS and first not in ring
    assert ring[-1].name == "tracing.filler"


@pytest.mark.parametrize("depth", [1, 2])
def test_spans_are_host_events_of_the_profiler(depth):
    from torch.profiler import ProfilerActivity, profile

    names = [f"tracing.level{i}" for i in range(depth)]
    with profiling.span("tracing.unprofiled") as off:
        pass
    assert off._record is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spans = [profiling.span(n) for n in names]
        for s in spans:
            s.__enter__()
        torch.ones(16, 16) @ torch.ones(16, 16)
        for s in reversed(spans):
            s.__exit__(None, None, None)
    events = {e.name: e for e in prof.events() if e.name in names or e.name == "aten::mm"}
    assert set(events) == {*names, "aten::mm"}
    mm = events["aten::mm"].time_range
    for n in names:
        assert events[n].time_range.start <= mm.start and mm.end <= events[n].time_range.end
    assert [s.parent for s in spans[1:]] == [s.id for s in spans[:-1]]


class StandInGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replays_count_the_launches_their_capture_made():
    before = {**cuda_fusion.LAUNCHES, **cuda_texthead.LAUNCHES}

    def capture():  # what the kernels' wrappers count while a graph captures
        for counts in (cuda_fusion.LAUNCHES, cuda_texthead.LAUNCHES):
            for name in counts:
                counts[name] += 1
        cuda_texthead.LAUNCHES["texthead_fwd"] += 1

    launches = _build.uncounted(capture)
    assert {**cuda_fusion.LAUNCHES, **cuda_texthead.LAUNCHES} == before
    step = object.__new__(scan._CapturedStep)
    step.kind, step.graph, step.launches = "train", StandInGraph(), launches
    step.idx, step.sums = torch.zeros(4, dtype=torch.int32), torch.ones(3)
    replays = profiling.COUNTERS.get("scan.replays.train", 0)
    step.run(torch.arange(20, dtype=torch.int32).reshape(5, 4))
    after = {**cuda_fusion.LAUNCHES, **cuda_texthead.LAUNCHES}
    assert {k: after[k] - before[k] for k in before} == {
        **dict.fromkeys(before, 5), "texthead_fwd": 10}
    assert step.graph.replays == 5 and profiling.COUNTERS["scan.replays.train"] == replays + 5
    assert torch.equal(step.idx, torch.arange(16, 20, dtype=torch.int32))
    last = profiling.spans()[-1]
    assert last.name == "scan.replays" and len(last.attrs["stamps"]) == 5


def _bench_module(name):
    if str(BENCH_DIR) not in sys.path:
        sys.path.append(str(BENCH_DIR))
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  BENCH_DIR / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _span(name, start_us, end_us, parent=None, epoch=7, **attrs):
    s = profiling.Span(name, parent.id if parent else None, epoch, attrs)
    s.id = next(profiling._IDS)
    s.start_ns, s.end_ns = int(start_us * 1e3), int(end_us * 1e3)
    return s


OFFSET_US = -1_000_250.5  # the profile's clock less the spans'
T0 = 2_000_000.0  # the epoch's start on the spans' clock, µs


def synthetic_run(delays_us=(0.0, 3.0, -2.0)):
    """A profiled epoch of 3 train steps: the spans, and the profile the
    program would have made, on a clock ``OFFSET_US`` from the spans', each
    launch ``delays_us`` from its stamp's place there.
    The device idles 400 µs in the index matrix, 100 µs while the second
    launch is under way and 50 µs between two kernels during the read (the
    device's backlog, both), 400 µs in the TensorBoard write and 300 µs in
    the callbacks; (readings, spans, idle µs in the loop's spans)."""
    epoch = _span("loop.epoch", T0, T0 + 20_000)
    train = _span("loop.train_pass", T0, T0 + 10_000, epoch)
    stamps = [T0 + 1_000 + 2_000 * k for k in range(3)]
    spans = [
        epoch, train,
        _span("epoch.index_matrix", T0, T0 + 500, train),
        _span("scan.replays", T0 + 900, T0 + 7_000, train, kind="train", steps=3,
              stamps=[int(t * 1e3) for t in stamps]),
        _span("scan.read_means", T0 + 7_000, T0 + 8_000, train),
        _span("loop.tb_write", T0 + 8_000, T0 + 10_000, train),
        _span("loop.callbacks", T0 + 12_000, T0 + 19_000, epoch),
        _span("loop.preemption_read", T0 + 18_000, T0 + 19_000, epoch),
    ]
    on = lambda t: t + OFFSET_US  # noqa: E731
    events = [("dev", on(s), on(e)) for s, e in
              ((T0 + 400, T0 + 1_100), (T0 + 1_200, T0 + 7_300), (T0 + 7_350, T0 + 8_000),
               (T0 + 8_400, T0 + 12_500), (T0 + 12_800, T0 + 18_000))]
    launches = [on(t) + d for t, d in zip(stamps, delays_us)]
    profile = {"device_events": events, "graph_launches": launches + [on(T0 + 11_000)]}
    idle_loop = 400 + 400 + 300  # the index matrix's, TensorBoard's, the callbacks'
    return {"profile": profile, "steps_per_epoch": 3}, spans, idle_loop


def test_alignment_finds_the_planted_offset_and_idle(monkeypatch):
    spans_mod = _bench_module("_spans")
    readings, spans, idle_loop = synthetic_run()
    monkeypatch.setattr(spans_mod, "program_spans", lambda: spans)
    epoch = spans_mod.profiled_epoch(readings)
    assert epoch["offset_us"] == pytest.approx(OFFSET_US, abs=1e-3)
    # statistics.quantiles of (-2, 0, 3): the quartiles -2 and 3
    assert epoch["spread_us"] == pytest.approx(5.0, abs=1e-3)
    assert sum(e - s for s, e in epoch["idle"]) == pytest.approx(idle_loop + 150, abs=1e-3)
    assert epoch["backlog"] == [pytest.approx((T0 + 900 + OFFSET_US, T0 + 8_000 + OFFSET_US))]
    assert spans_mod.idle_by_span(epoch) == pytest.approx(
        {"epoch.index_matrix": 400, "backlog": 150, "loop.tb_write": 400,
         "loop.callbacks": 300}, abs=1e-3)
    reader = _bench_module("loop.idle_ms")
    monkeypatch.setattr(reader._spans, "program_spans", lambda: spans)
    assert reader.read(readings) == pytest.approx(idle_loop / 1e3, abs=1e-6)


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_a_profile(name):
    reader = _bench_module(name)
    assert reader.read({"profile": None, "steps_per_epoch": 3}) is None


@pytest.mark.parametrize("name, span, seconds", [("setup.store_s", "store.build", 3.5),
                                                 ("setup.capture_s", "scan.capture", 1.25)])
def test_set_up_readers_sum_their_spans(monkeypatch, name, span, seconds):
    reader = _bench_module(name)
    spans = [_span(span, 0, seconds * 1e6 / 2, epoch=None),
             _span(span, 5e6, 5e6 + seconds * 1e6 / 2, epoch=None), _span("other", 0, 9e6)]
    monkeypatch.setattr(reader._spans, "program_spans", lambda: spans)
    readings, _, _ = synthetic_run()
    assert reader.read(readings) == pytest.approx(seconds)
