"""The four CUDA kernels' limits, gates and path decision, their byte
counts, and the build's view of their sources, checked without a card;
and on the card, the step on grids deeper than the kernels take.

Each kernel keeps whole columns in shared memory (the tracer's CF and FC,
the solve's CF and DC, KPP's FC column, the momentum r.h.s.'s spline);
each module states its deepest column once, in NZ_MAX, which its launch
guard reads.  Every depth the repo uses passes it; outside 2 <= nz <=
NZ_MAX it raises ValueError before any launch.  Each wrapper decides its
path in `_build.dispatch`: a CPU tensor takes the plain version at any
depth, another device than CUDA raises, and on CUDA a configuration its
gate refuses (a mesh pad; never the depth) takes the plain version too;
`_build.kernel_stats` counts each path.
`launch_bytes` of the KPP and solve kernels counts each tensor the kernel
reads or writes once.  Every header a source includes enters the hash
that names the built library, so a changed header is rebuilt.

On the card (marked `h100`; the test skips where there is no CUDA
device, deciding inside the test): a production grid 161 levels deep
stops at KPP's guard (KPP takes 160), and without KPP 193 levels deep at
the tracer stage's (the others take 192).  On the card this
file runs without the repository's conftest (which loads JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_column_launch.py
"""

import re

import pytest
import torch

from roms_tpu_torch.ops import _build, _harness, cuda_kpp, cuda_solve

import torch_kernel_args as ka

torch.set_num_threads(1)

KERNELS = list(ka.MODULES)


def _tensors(d, dtype):
    return {k: torch.as_tensor(v, dtype=dtype) for k, v in d.items()}


def _path(kernel, monkeypatch, nz=10, device="cuda", parts=False,
          **change):
    """The path ("launches" or "plain") that the kernel's wrapper takes for
    a tensor on `device` (a stand-in for a CUDA tensor), with stand-ins for
    its launch path and its plain version; checks that the one taken saw
    the wrapper's arguments unchanged and that the one counter moved by
    one on that path alone."""
    mod = ka.MODULES[kernel]
    name, plain = ka.WRAPPERS[kernel]
    ref = torch.empty(0) if device == "cpu" else \
        type("OnCard", (), {"device": torch.device(device, 0)})()
    a, kw = ka.args(kernel, nz, ref=ref, **change)
    if kernel == "uv_rhs":
        kw["parts"] = parts
    seen = []
    for path, attr in (("launches", "_launch"), ("plain", plain)):
        monkeypatch.setattr(mod, attr, lambda *x, _p=path, **k: seen.append(
            (_p, [id(v) for v in (*x, *k.values())])) or _p)
    before = dict(_build.kernel_stats[kernel])
    took = getattr(mod, name)(*a, **kw)
    assert seen == [(took, [id(v) for v in (*a, *kw.values())])]
    after = _build.kernel_stats[kernel]
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == took) for k in after}
    return took


@pytest.mark.parametrize("kernel", KERNELS)
def test_nz_max_reaches_every_depth_the_repo_uses(kernel, monkeypatch):
    """The wrapper takes the kernel on the card, and the launch guard
    passes, at every depth of the repo's cases and cells, in both
    types."""
    mod = ka.MODULES[kernel]
    assert mod.NZ_MAX >= 128
    depths = (10, 16, 32, 50, 60, mod.NZ_MAX)
    for nz in depths:
        assert _path(kernel, monkeypatch, nz) == "launches"
    monkeypatch.undo()
    lib = ka.fake_library(monkeypatch)
    for nz in depths:
        for dtype in (torch.float32, torch.float64):
            a, kw = ka.args(kernel, nz, dtype)
            mod._launch(*a, **kw)
    assert len(lib.calls) == 12


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("nz", [1, "max+1"])
def test_nz_outside_the_kernel_raises(kernel, nz, monkeypatch):
    """The wrapper does not read the depth: on the card it takes the
    launch path, whose guard raises before any launch, so no column is
    handed to a kernel that cannot hold it, and none moves to the plain
    version unseen."""
    mod = ka.MODULES[kernel]
    nz = mod.NZ_MAX + 1 if nz == "max+1" else nz
    assert _path(kernel, monkeypatch, nz) == "launches"
    monkeypatch.undo()
    lib = ka.fake_library(monkeypatch)
    a, kw = ka.args(kernel, nz)
    with pytest.raises(ValueError, match=f"{kernel}: the kernel takes"):
        mod._launch(*a, **kw)
    assert lib.calls == []


# (extra settings of the admitted configuration, settings the gate refuses)
GATES = {
    "tracer_stage": ({}, [dict(river_source=True), dict(adv_isoneutral=True),
                          dict(upscale_output=True),
                          dict(tracer_diagnostics=True), dict(pad_e=1),
                          dict(pad_n=1)]),
    "momentum_solve": ({}, []),
    "kpp_vmix": (dict(lmd_kpp=True), [dict(lmd_kpp=False), dict(pad_e=1),
                                      dict(pad_n=1)]),
    "uv_rhs": ({}, [dict(pad_e=1), dict(pad_n=1), dict(parts=True)]),
}


@pytest.mark.parametrize("kernel", KERNELS)
def test_gate_reads_depth_and_pad(kernel, monkeypatch):
    """What each wrapper's path on the card reads: never the depth (that
    is the launch guard's); the mesh pad for KPP (with `lmd_kpp`) and the
    momentum r.h.s. (with the budget's split), which take the plain
    version there; nothing for the solve, which runs on a mesh block's
    padded grid too.  The tracer's wrapper launches whatever the
    configuration: its gate `usable` is the step's, which refuses the
    batched branch's options and the pad and reads no depth either."""
    mod = ka.MODULES[kernel]
    extra, refused = GATES[kernel]
    for nz in (1, 2, 60, mod.NZ_MAX, mod.NZ_MAX + 1):
        assert _path(kernel, monkeypatch, nz, **extra) == "launches"
    on_card = "launches" if kernel == "tracer_stage" else "plain"
    for change in refused:
        assert _path(kernel, monkeypatch, **{**extra, **change}) == \
            on_card, change
    if kernel == "tracer_stage":
        cfg = ka.config(kernel, 60)
        for nz in (1, mod.NZ_MAX + 1):
            assert mod.usable(cfg.replace(nz=nz))
        for change in refused:
            assert not mod.usable(cfg.replace(**change)), change
    if kernel == "momentum_solve":
        assert _path(kernel, monkeypatch, pad_e=1, pad_n=1) == "launches"


@pytest.mark.parametrize("kernel", KERNELS)
def test_no_kernel_for_another_device(kernel):
    """A tensor on a device with no kernel raises, whatever the gate
    says; nothing moves to the CPU plain version."""
    mod = ka.MODULES[kernel]
    wrapper = getattr(mod, ka.WRAPPERS[kernel][0])
    for nz in (10, mod.NZ_MAX + 1):
        a, kw = ka.args(kernel, nz, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            wrapper(*a, **kw)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("device, nz, takes", [
    ("cpu", 10, "plain"), ("cuda", 10, "launches"),
    ("cpu", "max+1", "plain")])
def test_wrapper_takes_its_path(kernel, device, nz, takes, monkeypatch):
    """The wrapper's path by device: a CPU tensor takes the plain version
    at any depth, a CUDA tensor the kernel; its arguments passed on
    unchanged, and the one counter moved by one."""
    nz = ka.MODULES[kernel].NZ_MAX + 1 if nz == "max+1" else nz
    assert _path(kernel, monkeypatch, nz, device) == takes


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("drag", [False, True])
def test_solve_bytes_count_each_tensor_once(drag, dtype):
    cfg, d = _harness.solve_inputs(nz=7)
    x = _tensors(d, dtype)
    ins = [x["rhs"], x["hzf"], x["akvf"], x["wif"], x["dc0"], x["sstr"]]
    if drag:
        ins.append(x["rd"])
    nz, jy, ix = x["rhs"].shape
    out = torch.empty_like(x["rhs"])
    assert cuda_solve.launch_bytes(nz, jy, ix, out.element_size(), drag) \
        == _build.compulsory_bytes(ins, (out,))


@pytest.mark.parametrize("salinity,masking", [(True, True), (True, False),
                                              (False, True), (False, False)])
def test_kpp_bytes_count_each_tensor_once(salinity, masking):
    """The tensors the kernel reads (the surface T and S levels, the
    surface fluxes of T and S) and writes (akv, Kt and Ks, ghat, hbls,
    hbbl), each once."""
    cfg, d = _harness.kpp_inputs(nz=7, salinity=salinity, masking=masking)
    x = _tensors(d, torch.float64)
    nz, jy, ix = x["u"].shape
    sal = [cfg.isalt] if salinity else []
    ins = [x[k] for k in ("u", "v", "bvf", "z_r", "z_w", "hz", "swrf")]
    ins += [x["t"][n, nz - 1] for n in [cfg.itemp, *sal]]
    ins += [x["stflx"][n] for n in [cfg.itemp, *sal]]
    ins += [x[k] for k in ("srflx", "sustr", "svstr", "f", "hbls", "hbbl")]
    if masking:
        ins += [x[k] for k in ("rmask", "umask", "vmask")]
    outs = [torch.empty(nz + 1, jy, ix, dtype=torch.float64)
            for _ in range(2 + cfg.i_t_and_s)]
    outs += [torch.empty(jy, ix, dtype=torch.float64) for _ in range(2)]
    assert cuda_kpp.launch_bytes(nz, jy, ix, 8, salinity, masking) \
        == _build.compulsory_bytes(ins, outs)


def test_every_included_header_enters_the_library_hash(tmp_path,
                                                        monkeypatch):
    included = set()
    for name in _build.SOURCES:
        included |= set(re.findall(r'#include "([^"]+)"',
                                   (_build.CSRC / name).read_text()))
    assert included == set(_build.HEADERS)
    # a copy of the sources: editing a header renames the library
    for name in (*_build.SOURCES, *_build.HEADERS):
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path()
    header = tmp_path / _build.HEADERS[0]
    header.write_text(header.read_text() + "\n")
    assert _build.library_path() != before


# ---------------------------------------------------------------- the card
@pytest.mark.h100
@pytest.mark.parametrize("nz, lmd_kpp, kernel", [
    (161, True, "kpp_vmix"), (193, False, "tracer_stage")])
def test_deep_grid_steps_on_the_card(nz, lmd_kpp, kernel):
    """Production at 12x10 (open boundaries, f64): a column deeper than
    the first kernel of the step takes (KPP's 160 levels; without KPP the
    tracer's 192) stops the step with that kernel's ValueError, before any
    kernel is launched and without a plain version run in its place."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the test runs only on the card")
    from roms_tpu_torch.cases import bench_production
    from roms_tpu_torch.driver import run
    cfg = bench_production.config(nx=12, ny=10, nz=nz, nt=4).replace(
        lmd_kpp=lmd_kpp)
    grid, st, frc = bench_production.setup(cfg, dtype=torch.float64)
    before = {k: dict(v) for k, v in _build.kernel_stats.items()}
    with pytest.raises(ValueError, match=f"{kernel}: the kernel takes 2 "
                       f"<= nz"):
        run(grid, st, frc, cfg, nsteps=2, collect_diag=False)
    assert _build.kernel_stats == before
