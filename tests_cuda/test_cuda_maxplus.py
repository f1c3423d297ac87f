"""K9, the max-plus sweep experiment (``ck.maxplus_sweeps``), on the
card: both layouts bit-equal to the plain version (every operation is an
exact max or one rounded add or subtract), at Sp = 5 (one partial warp),
256 (T is 256 KB, past a block's shared memory), 257 (two states a
thread), 512 and 1024 (four), at each row-block size of the blocks
layout; a Bg that does not fill the last block of columns."""

import pytest

torch = pytest.importorskip("torch")

from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tehmm_tpu_torch.tools import exp_maxplus_s256 as tool  # noqa: E402

pytestmark = pytest.mark.cuda

LAYOUTS = [("resident", None), ("blocks", 8), ("blocks", 16),
           ("blocks", 32)]


@pytest.mark.parametrize("layout,blk", LAYOUTS)
@pytest.mark.parametrize("Sp,Bg", [(5, 13), (256, 128), (257, 37),
                                   (512, 128), (1024, 40)])
def test_layouts_bit_equal_plain(device, Sp, Bg, layout, blk):
    v, t = tool.make_inputs(Sp, Bg, device)
    before = ck.LAUNCHES["maxplus_" + layout]
    got = ck.maxplus_sweeps(v, t, layout, blk)
    assert ck.LAUNCHES["maxplus_" + layout] == before + 1
    assert torch.equal(got, ck.maxplus_sweeps_plain(v, t))
    assert torch.equal(got, ck.maxplus_sweeps(v, t, layout, blk))


def test_outside_the_kernels_raises(device):
    v = torch.zeros((1025, 4), device=device)
    t = torch.zeros((1025, 1025), device=device)
    with pytest.raises(NotImplementedError, match="1024"):
        ck.maxplus_sweeps(v, t, "resident")
    v, t = tool.make_inputs(8, 4, device)
    with pytest.raises(ValueError, match="blk"):
        ck.maxplus_sweeps(v, t, "blocks", 12)


def test_tool_prints_its_rows_on_the_card(device, capsys):
    assert tool.main(["--device", "cuda", "--reps", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    rows = [line for line in lines if not line.startswith("#")]
    assert len(rows) == 4
    assert all(" ok " in r and "max|delta| 0.00e+00" in r for r in rows)
