"""Unit tests for the measurement/hygiene tooling in tools/.

These are plain-Python helpers (no backend); a parser bug here would
silently corrupt the collective census the scaling tool reports.
"""

import os
import sys


sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from multichip_scaling import collective_census, _shape_bytes  # noqa: E402


def test_shape_bytes_scalar_tuple_layout():
    assert _shape_bytes("f32[64,3]{1,0}") == 64 * 3 * 4
    assert _shape_bytes("(f32[8]{0}, s32[4]{0})") == 8 * 4 + 4 * 4
    assert _shape_bytes("pred[]") == 1
    assert _shape_bytes("bf16[128,128]{1,0}") == 128 * 128 * 2


def test_collective_census_counts_ops(tmp_path):
    hlo = "\n".join([
        "%ag = f32[8,64]{1,0} all-gather(f32[1,64]{1,0} %x), dims={0}",
        "%cp = f32[2,16]{1,0} collective-permute(f32[2,16]{1,0} %y)",
        "%ar = (f32[64]{0}, f32[64]{0}) all-reduce(f32[64]{0} %a, "
        "f32[64]{0} %b)",
        "%notcoll = f32[64]{0} add(f32[64]{0} %p, f32[64]{0} %q)",
    ])
    (tmp_path / "m.before_optimizations.txt").write_text("IGNORED")
    (tmp_path / "m.after_optimizations.txt").write_text(hlo)
    census = collective_census(str(tmp_path))
    assert census["all-gather"] == {"count": 1, "out_bytes": 8 * 64 * 4}
    assert census["collective-permute"]["count"] == 1
    assert census["all-reduce"]["out_bytes"] == 2 * 64 * 4
    assert "add" not in census
