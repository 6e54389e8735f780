"""The kernels' limits and shared layout, read from their CUDA sources,
against the Python wrappers that check shapes before a launch
(``liwslam_torch/ops/track_solve.py``, ``cam_solve.py``, ``extract.py``,
``lk.py``), so that a kernel and its wrapper cannot drift apart unseen.
Runs without a GPU: it parses the sources."""

import pathlib
import re

import pytest

from liwslam_torch.ops import cam_solve as cs
from liwslam_torch.ops import extract as ext
from liwslam_torch.ops import lk
from liwslam_torch.ops import track_solve as ts

CSRC = pathlib.Path(__file__).resolve().parents[1] / "liwslam_torch" / "csrc"


def _src(name):
    return (CSRC / name).read_text()


def _consts(*names):
    """Every ``#define NAME <int>`` and ``constexpr int NAME = <expr>;`` of
    the sources, evaluated in order (an expression may use the names before
    it)."""
    env = {}
    for name in names:
        src = _src(name)
        env.update({k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)\n", src)})
        for key, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", src):
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


@pytest.mark.parametrize("name", ["track_solve", "cam_solve", "extract_lines", "lk_track"])
def test_attribute_query_reports_the_launched_kernel(name):
    """``liwslam_<name>_attributes`` (read by chip_smoke.kernel_resources)
    queries the kernel that ``liwslam_<name>`` launches; for B3, which has
    one instantiation for small radii and one for large, the one that
    radii up to SMALL_RADIUS launch (the camera path's radius 7)."""
    src = _src(name + ".cu")
    launched = re.findall(r"(\w+_kernel(?:<\w+>)?)<<<", src)
    query = re.search(r'extern "C" int liwslam_%s_attributes\(int\* regs, int\* local_bytes\) \{(.*?)\n\}' % name, src, re.S)
    assert query and "a.numRegs" in query.group(1) and "a.localSizeBytes" in query.group(1)
    if name == "lk_track":
        assert launched == ["lk_track_kernel<ROWS_SMALL>", "lk_track_kernel<ROWS_LARGE>"]
        assert re.search(r"if \(radius <= SMALL_RADIUS\)\s+lk_track_kernel<ROWS_SMALL><<<", src)
        assert "cudaFuncGetAttributes(&a, lk_track_kernel<ROWS_SMALL>)" in query.group(1)
        assert _consts("lk_track.cu")["SMALL_RADIUS"] >= 7
    else:
        assert launched == [name + "_kernel"]
        assert "cudaFuncGetAttributes(&a, %s_kernel)" % name in query.group(1)


def _lk_geo(radius):
    """lk_track.cu's ``Geo`` for ``radius``, evaluated from the source."""
    env = dict(_consts("lk_track.cu"), r=radius)
    body = re.search(r"struct Geo \{.*?\{(.*?)\n  \}", _src("lk_track.cu"), re.S).group(1)
    for key, expr in re.findall(r"(\w+) = ([^;]+);", body):
        env[key] = eval(expr.replace("/", "//"), {}, dict(env))
    return env


def _lk_track_bytes(radius, levels):
    g = _lk_geo(radius)
    return 4 * (g["XB"] + g["per_level"] * levels)


def test_lk_limits_match_the_kernel():
    env = _consts("lk_track.cu")
    assert (lk.MAX_LEVELS, lk.MAX_RADIUS, lk.MARGIN) == (env["MAX_LEVELS"], env["MAX_RADIUS"], env["MARGIN"])
    src = _src("lk_track.cu")
    assert "levels > MAX_LEVELS || radius < 0 || radius > MAX_RADIUS" in src
    # the largest track a block must hold, alone: the wrapper admits it
    assert _lk_track_bytes(lk.MAX_RADIUS, lk.MAX_LEVELS) <= env["SMEM_MAX"]
    # the camera path's track (radius 7, 3 levels): a full block of tracks,
    # and each track's named barrier covers part of the block, not all
    tpb = env["BLOCK_WARPS"] // env["WPT"]
    assert tpb >= 2 and tpb * _lk_track_bytes(7, 3) <= env["SMEM_MAX"]
    assert tpb + 1 <= 16, "named barrier ids 1..tpb"
    # a lane's rows cover every patch row of its instantiation
    assert env["ROWS_SMALL"] * 2 * env["WPT"] >= 2 * env["SMALL_RADIUS"] + 1 and 2 * env["SMALL_RADIUS"] + 1 <= 16
    assert env["ROWS_LARGE"] * env["WPT"] >= 2 * env["MAX_RADIUS"] + 1
    # every region a multiple of 4 floats (16-byte cp.async), each window's
    # columns whole 16-byte chunks and, where half warps take a row, its
    # row stride 16 banks from the next
    assert env["XB"] % 4 == 0 and env["XB"] >= 4 * env["WPT"]
    for r in range(env["MAX_RADIUS"] + 1):
        g = _lk_geo(r)
        for cols, rows, stride in (("C0", "Q", "S0"), ("C1", "WS", "S1")):
            # the window spans its rows' taps from a start rounded down to 4
            assert g[cols] % 4 == 0 and g[cols] >= g[rows] + 3, (r, cols)
            if g["P"] <= 16:  # half warps a row: rows 16 banks apart
                assert g[stride] >= g[cols] and g[stride] % 32 == 16, (r, stride)
            else:
                assert g[stride] == g[cols], (r, stride)
        for key in ("w1", "pd", "part", "sums", "per_level"):
            assert g[key] % 4 == 0, (r, key)


def test_extract_limits_match_the_kernel():
    env = _consts("extract_lines.cu")
    assert ext.N_MAX == env["N_MAX"]
    assert env["POINT_BYTES"] * env["N_MAX"] <= env["SMEM_MAX"]
    assert env["MAXP"] * env["THREADS"] >= env["N_MAX"]
    src = _src("extract_lines.cu")
    assert "N < 1 || N > N_MAX" in src
    # POINT_BYTES is the layout the kernel carves: six float64 prefix
    # arrays, then float arrays each N past the one before, then the ints
    kernel = src[src.index("extract_lines_kernel("):]
    assert "double* cs = smem;" in kernel and "(float*)(cs + 6 * N)" in kernel
    floats = 1 + len(re.findall(r"float\* \w+ = \w+ \+ N;", kernel))
    ints = len(re.findall(r"int\* \w+ = (?:\(int\*\)\(\w+ \+ N\)|\w+ \+ N);", kernel))
    assert 6 * 8 + 4 * floats + 4 * ints == env["POINT_BYTES"]
    assert "POINT_BYTES * N, (cudaStream_t)stream" in src
