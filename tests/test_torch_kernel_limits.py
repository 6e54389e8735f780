"""The LM kernels' limits and shared layout, read from their CUDA sources,
against the Python wrappers that check shapes before a launch
(``liwslam_torch/ops/track_solve.py``, ``liwslam_torch/ops/cam_solve.py``),
so that a kernel and its wrapper cannot drift apart unseen.  Runs without a
GPU: it parses the sources."""

import pathlib
import re

import pytest

from liwslam_torch.ops import cam_solve as cs
from liwslam_torch.ops import track_solve as ts

CSRC = pathlib.Path(__file__).resolve().parents[1] / "liwslam_torch" / "csrc"


def _src(name):
    return (CSRC / name).read_text()


def _consts(*names):
    """Every ``constexpr int NAME = <expr>;`` of the sources, evaluated in
    order (an expression may use the names before it)."""
    env = {}
    for name in names:
        for key, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", _src(name)):
            env[key] = eval(expr.replace("/", "//"), {}, dict(env))
    return env


def _struct_floats(src, name, env):
    """Size in 4-byte words of ``struct name`` of float / int fields,
    float arrays and nested structs of the same kind."""
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    words = 0
    for line in body.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if not line:
            continue
        kind, rest = line.split(None, 1)
        if kind in ("float", "int"):
            for field in rest.split(","):
                dims = re.findall(r"\[([^\]]+)\]", field)
                n = 1
                for d in dims:
                    n *= eval(d, {}, dict(env))
                words += n
        else:
            words += _struct_floats(src, kind, env)
    return words


def test_track_solve_limits_match_the_kernel():
    env = _consts("solve_common.cuh", "track_solve.cu")
    assert ts.M_MAX == env["M_MAX"]
    assert ts.D == env["D"]
    # the C entry point refuses what the wrapper refuses
    assert "M > M_MAX" in _src("track_solve.cu")


def test_cam_solve_limits_match_the_kernel():
    env = _consts("solve_common.cuh", "cam_solve.cu")
    for key in ("F_MAX", "WC_MAX", "SMEM_MAX", "FIXED", "PER_FW", "PER_F"):
        assert getattr(cs, key) == env[key], key
    src = _src("cam_solve.cu")
    assert "(size_t)FIXED + PER_FW * (size_t)F * Wc + PER_F * (size_t)F" in src
    assert "F > F_MAX || Wc < 1 || Wc > WC_MAX || bytes > SMEM_MAX" in src


def test_cam_solve_shared_layout_fits_its_terms():
    env = _consts("solve_common.cuh", "cam_solve.cu")
    src = _src("solve_common.cuh") + _src("cam_solve.cu")
    fixed = _struct_floats(src, "Fixed", env)
    assert fixed <= env["FIXED"] and env["FIXED"] % 4 == 0
    assert env["FIXED"] - fixed < 4, "FIXED wastes shared memory"
    # lm_layout: the per-landmark part, each `p += <k> * F`, `<k> * FW` or `F`
    body = re.search(r"Lm lm_layout\(.*?\n\}", src, re.S).group(0)
    loop = re.search(r"for \(int k = 0; k < 2; \+\+k\) \{(.*?)\n  \}", body, re.S)
    per_f = per_fw = 0
    for block, reps in ((body.replace(loop.group(0), ""), 1), (loop.group(1), 2)):
        for expr in re.findall(r"p \+= ([^;]+);", block):
            m = re.fullmatch(r"(?:(\d+) \* )?(FW|F)", expr.strip())
            assert m, expr
            k = int(m.group(1) or 1) * reps
            if m.group(2) == "FW":
                per_fw += k
            else:
                per_f += k
    # the last array (glA, 3 a landmark) is carved without a `p +=`
    assert "l.glA = p;" in body
    per_f += 3
    assert (per_f, per_fw) == (env["PER_F"], env["PER_FW"])


@pytest.mark.parametrize("F,Wc", [(1, 1), (48, 8), (256, 14), (153, 32), (256, 15), (154, 32)])
def test_smem_bytes_is_the_kernels_formula(F, Wc):
    env = _consts("solve_common.cuh", "cam_solve.cu")
    want = 4 * (env["FIXED"] + env["PER_FW"] * F * Wc + env["PER_F"] * F)
    assert cs.smem_bytes(F, Wc) == want
    # the edges chip_smoke.py drives: the largest (F, Wc) admitted at
    # F = F_MAX and at Wc = WC_MAX, and one past each
    admitted = (F, Wc) not in ((256, 15), (154, 32))
    assert (want <= env["SMEM_MAX"]) == admitted


@pytest.mark.parametrize("name", ["track_solve", "cam_solve"])
def test_attribute_query_reports_the_launched_kernel(name):
    """``liwslam_<name>_attributes`` (read by chip_smoke.kernel_resources)
    queries the kernel that ``liwslam_<name>`` launches."""
    src = _src(name + ".cu")
    launched = re.findall(r"(\w+_kernel)<<<", src)
    query = re.search(r'extern "C" int liwslam_%s_attributes\(int\* regs, int\* local_bytes\) \{(.*?)\n\}' % name, src, re.S)
    assert launched == [name + "_kernel"] and query
    assert "cudaFuncGetAttributes(&a, %s_kernel)" % name in query.group(1)
    assert "a.numRegs" in query.group(1) and "a.localSizeBytes" in query.group(1)
