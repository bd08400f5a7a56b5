"""Launch limits of the KPP and momentum-solve kernels, their byte
counts, and the build's view of their sources, checked without a card.

Each kernel keeps whole columns in shared memory (the solve's CF and DC,
KPP's FC column); the launch sizes it from (type, nz) in C, and the
wrappers cap nz at NZ_MAX.  Every depth the repo uses is accepted; a
column outside the range raises ValueError before any launch, shown on
meta tensors, which take no memory (the largest accepted nz is launched
on the card by chip_smoke.py).  Each wrapper's `last_bytes`, the
compulsory bytes that chip_smoke.py's bound reads, comes from the shapes
(`launch_bytes`) and counts each tensor the kernel reads or writes once.
Every header a source includes enters the hash that names the built
library, so a changed header is rebuilt.
"""

import re
import types

import pytest
import torch

from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.ops import _build, _harness, cuda_kpp, cuda_solve

torch.set_num_threads(1)

MODULES = {"solve": cuda_solve, "kpp": cuda_kpp}


@pytest.mark.parametrize("which", list(MODULES))
def test_nz_max_reaches_every_depth_the_repo_uses(which):
    mod = MODULES[which]
    assert mod.NZ_MAX >= 128
    for nz in (10, 16, 32, 60, mod.NZ_MAX):
        mod.check_nz(nz)


def _tensors(d, dtype):
    return {k: torch.as_tensor(v, dtype=dtype) for k, v in d.items()}


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


@pytest.mark.parametrize("which", list(MODULES))
@pytest.mark.parametrize("nz", [1, "max+1"])
def test_nz_outside_the_kernel_raises(which, nz):
    mod = MODULES[which]
    nz = mod.NZ_MAX + 1 if nz == "max+1" else nz
    with pytest.raises(ValueError, match="nz"):
        mod.check_nz(nz)
    jy, ix = 8, 36

    def m(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    f3, w3, p2 = m(nz, jy, ix), m(nz + 1, jy, ix), m(jy, ix)
    cfg = ModelConfig(nx=ix - 4, ny=jy - 4, nz=nz, nt=2, lmd_kpp=True)
    with pytest.raises(ValueError, match="nz"):
        if which == "solve":
            cuda_solve.momentum_implicit(f3, f3, w3, w3, p2, 1.0, p2, cfg)
        else:
            ns = types.SimpleNamespace
            cuda_kpp.vmix_update(
                ns(swrf=w3, hbls=p2, hbbl=p2), f3, f3, m(2, nz, jy, ix), w3,
                f3, w3, f3, ns(stflx=m(2, jy, ix), srflx=p2, sustr=p2,
                               svstr=p2),
                ns(f=p2, rmask=p2, umask=p2, vmask=p2, own_w=None,
                   own_e=None, own_s=None, own_n=None), cfg, False)


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
