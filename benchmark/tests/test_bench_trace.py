"""The trace readers on synthetic profiler events."""

import types
from pathlib import Path

import pytest

from benchmark import harness, trace, work

BENCH = Path(__file__).resolve().parents[1]


def ev(name, cat, a, b):
    return (name, cat, a, b)


EVENTS = [
    ev('bench.epoch', 'user_annotation', 0, 1000),
    ev('bench.epoch', 'gpu_user_annotation', 0, 1000),   # not device work
    ev('aten::mul', 'cpu_op', 10, 20),
    ev('cudaLaunchKernel', 'cuda_runtime', 12, 14),
    ev('void msdb::fwd_kernel<float, true, true, false>(x)', 'kernel', 100, 300),
    ev('void (anonymous namespace)::bwd_kernel<float, true, false>(y)',
       'kernel', 250, 400),                              # overlaps the last
    ev('Memcpy HtoD (Pageable -> Device)', 'gpu_memcpy', 500, 550),
    ev('aten::copy_', 'cpu_op', 420, 560),
    ev('cudaMemcpyAsync', 'cuda_runtime', 430, 440),
    ev('cudaStreamSynchronize', 'cuda_runtime', 440, 555),
    ev('cudaMemcpy', 'cuda_runtime', 600, 610),
    ev('aten::index', 'cpu_op', 600, 900),
    ev('index_elementwise_kernel', 'kernel', 900, 950),
    ev('late_kernel', 'kernel', 1100, 1200),              # outside the window
]


def test_union_and_gaps():
    assert trace.union([(5, 7), (0, 2), (1, 3), (7, 9)]) == [(0, 3), (5, 9)]
    assert trace.gaps([(2, 3), (5, 9)], 0, 10) == [(0, 2), (3, 5), (9, 10)]
    assert trace.clip([(0, 5), (8, 12), (20, 30)], 2, 10) == [(2, 5), (8, 10)]


def test_summary():
    s = trace.summarize(EVENTS, 'bench.epoch')
    assert s.window_ns == 1000
    # the union of device work: [100, 400], [500, 550], [900, 950]
    assert s.busy_ns == 300 + 50 + 50
    assert s.launches == 4
    assert s.syncs == 2                     # the stream sync, the cudaMemcpy
    assert s.device_ops['index_elementwise_kernel'] == 50
    # gaps: [0,100] under 'aten::mul'? no: its midpoint 50 lies in no op
    # but the window's span; [400,500] mid 450 in cudaStreamSynchronize;
    # [550,900] mid 725 in aten::index; [950,1000] mid 975 in the span.
    assert s.idle_by_host_op == {'bench.epoch': 150, 'cudaStreamSynchronize':
                                 100, 'aten::index': 350}
    assert trace.top(s.idle_by_host_op, 2) == [['aten::index', 350e-9],
                                               ['bench.epoch', 150e-9]]


def test_summary_of_device_activity_alone():
    # A trace of the card's activity and the runtime calls, no host
    # operation or range: the window runs from the first CUDA call to the
    # last one's end.
    s = trace.summarize([e for e in EVENTS if e[1] not in
                         ('cpu_op', 'user_annotation')])
    assert s.window_ns == 610 - 12
    assert s.busy_ns == 300 + 50            # [100, 400], [500, 550]
    assert s.launches == 3 and s.syncs == 2
    assert s.device_ops == {
        'void msdb::fwd_kernel<float, true, true, false>(x)': 200,
        'void (anonymous namespace)::bwd_kernel<float, true, false>(y)': 150,
        'Memcpy HtoD (Pageable -> Device)': 50}


def test_device_copies_of_host_ranges_are_no_work():
    # A profiler that labels the device-side copy of a range a kernel.
    events = trace.mark_annotations(
        [ev('bench.epoch', 'cpu_op', 0, 1000),
         ev('bench.epoch', 'kernel', 0, 1000),
         ev('k', 'kernel', 100, 200)])
    s = trace.summarize(events, 'bench.epoch')
    assert s.busy_ns == 100 and s.launches == 1


def test_no_span_or_no_device_work():
    assert trace.summarize(EVENTS, 'other') is None
    assert trace.summarize([e for e in EVENTS if e[1] != 'kernel'
                            and e[1] != 'gpu_memcpy'], 'bench.epoch') is None


def ctx_for(summary, folder, n_angles=2, epoch_s=800e-9):
    cfg = {'obj_size': [256, 256, 256], 'binning': 8, 'probe_size': [72, 72],
           'n_probe_modes': 1}
    return types.SimpleNamespace(
        summary=summary, folder=folder, n_angles=n_angles, epoch_s=epoch_s,
        config=cfg,
        traffic={'grid': [23, 23], 'stride_px': 8}, work=work,
        peaks={'f32_flops_per_s': 67e12, 'bytes_per_s': 3.35e12})


def reader(name):
    return harness.load_reader(BENCH / 'metrics' / f'{name}.py')


def test_readers():
    s = trace.summarize(EVENTS, 'bench.epoch')
    ctx = ctx_for(s, BENCH / 'metrics' / 'multislice_roofline_pct')
    # 400 ns busy in the traced epoch, over the untraced epoch's 800 ns
    # (the traced one's 1000 ns would read 60%).
    assert reader('device_idle_pct')(ctx) == pytest.approx(50.0)
    assert reader('launches_per_angle')(ctx) == 2.0
    assert reader('syncs_per_angle')(ctx) == 1.0
    # K1f 200 ns + K1b 150 ns matched; two angles' bound over them.
    bound = work.multislice.bound_seconds(
        work.multislice.angle_work(ctx.config, ctx.traffic), ctx.peaks)[0]
    assert reader('multislice_roofline_pct')(ctx) == pytest.approx(
        100 * 2 * bound / 350e-9)


def test_readers_find_nothing():
    ctx = ctx_for(None, BENCH / 'metrics' / 'multislice_roofline_pct')
    for name in ('device_idle_pct', 'launches_per_angle', 'syncs_per_angle',
                 'multislice_roofline_pct'):
        assert reader(name)(ctx) is None
    s = trace.summarize([e for e in EVENTS if 'msdb' not in e[0]
                         and 'bwd_kernel' not in e[0]], 'bench.epoch')
    ctx = ctx_for(s, BENCH / 'metrics' / 'multislice_roofline_pct')
    assert reader('multislice_roofline_pct')(ctx) is None


def test_patterns_from_every_file(tmp_path):
    read = harness.load_reader(BENCH / 'metrics' / 'multislice_roofline_pct.py')
    folder = tmp_path / 'multislice_roofline_pct'
    folder.mkdir()
    (folder / 'a.txt').write_text('# K1\n\\bmsdb::fwd_kernel<\n')
    (folder / 'b.txt').write_text('fused_sweep_kernel  # a later form\n')
    events = EVENTS + [ev('fused_sweep_kernel<3>', 'kernel', 960, 990)]
    s = trace.summarize(events, 'bench.epoch')
    ctx = ctx_for(s, folder, n_angles=1)
    bound = work.multislice.bound_seconds(
        work.multislice.angle_work(ctx.config, ctx.traffic), ctx.peaks)[0]
    # the forward (200 ns) and the later form (30 ns); not the backward
    assert read(ctx) == pytest.approx(100 * bound / 230e-9)


def test_qualified_names_read_the_base_reader(tmp_path):
    (tmp_path / 'rate.py').write_text('')
    (tmp_path / 'rate.b.py').write_text('')
    assert harness._named(tmp_path, 'rate.a') == tmp_path / 'rate.py'
    assert harness._named(tmp_path, 'rate.b') == tmp_path / 'rate.b.py'
    assert harness._named(tmp_path, 'other') == tmp_path / 'other.py'
    assert (harness._named(BENCH / 'metrics', 'multislice_roofline_pct.x', '')
            == BENCH / 'metrics' / 'multislice_roofline_pct')
