"""chip_smoke.py's build record and attention shape list, on the CPU.

The build phase reads each library's ``-Xptxas -v`` log and its
``cuobjdump -sass`` text; on the card those come from ``nvcc``, here from
planted text in the tools' formats. ``check_attention_build`` is the gate
that fails the card run when ptxas serializes a wgmma of
``flash_attn_kernel`` or drops its named barriers or register moves.
"""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

MANGLED = "_ZN12_GLOBAL__N_117flash_attn_kernelILi{}ELb{}EEEv14CUtensorMap_stS1_S1_S1_S1_Pfiiiiiif"

LOG = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{MANGLED.format(128, 1)}' for 'sm_90a'
ptxas info    : Function properties for {MANGLED.format(128, 1)}
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 640 bytes cmem[0]
ptxas info    : Compiling entry function '{MANGLED.format(112, 0)}' for 'sm_90a'
ptxas info    : Function properties for {MANGLED.format(112, 0)}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 640 bytes cmem[0]
"""
SERIALIZED = ("ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions "
              f"are serialized due to the presence of Extern calls in the function "
              f"'{MANGLED.format(64, 0)}'")

SASS = f"""
\tcode for sm_90a
\t\tFunction : {MANGLED.format(64, 0)}
        /*0010*/                   USETMAXREG.DEALLOC.CTAPOOL 0x20 ;
        /*0020*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0030*/                   BAR.SYNC.DEFER_BLOCKING R3, 0x100 ;
        /*0040*/                   BAR.ARV R4, 0x100 ;
        /*0050*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0060*/                   UTMASTG.4D [UR4], [UR6] ;
\t\tFunction : {MANGLED.format(128, 1)}
        /*0020*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0050*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0060*/                   UTMALDG.4D [UR8], [UR4] ;
"""


def test_ptxas_report_reads_each_instantiation():
    rep = chip_smoke.ptxas_report(LOG)
    assert rep["functions"] == {
        "flash_attn_kernel<128,true>": dict(registers=168, spill_stores=8, spill_loads=4),
        "flash_attn_kernel<112,false>": dict(registers=168, spill_stores=0, spill_loads=0)}
    assert rep["advisories"] == []
    assert chip_smoke.ptxas_report(LOG + SERIALIZED)["advisories"] == [SERIALIZED.strip()]


def test_sass_counts_per_instantiation():
    ops = chip_smoke.sass_op_counts(SASS)
    one, two = ops["functions"]["flash_attn_kernel<64,false>"], \
        ops["functions"]["flash_attn_kernel<128,true>"]
    # __syncthreads' BAR.SYNC 0x0 is not a named barrier
    assert (one["BAR.SYNC named"], one["BAR.ARV"], one["USETMAXREG"]) == (1, 1, 1)
    assert (two["BAR.SYNC named"], two["BAR.ARV"], two["USETMAXREG"]) == (0, 0, 0)
    assert (ops["HGMMA"], ops["UTMALDG"], ops["UTMASTG"]) == (2, 1, 1)


@pytest.mark.parametrize("case", ["clean", "serialized", "no_ping_pong"])
def test_attention_build_gate(case):
    sass = chip_smoke.sass_op_counts(SASS)
    ping_pong = sass["functions"]["flash_attn_kernel<64,false>"]
    # D = 256 runs one consumer warpgroup: no named barriers, no setmaxnreg
    sass["functions"] = {"flash_attn_kernel<64,false>": ping_pong,
                         "flash_attn_kernel<256,false>": dict(ping_pong, **{
                             "BAR.SYNC named": 0, "BAR.ARV": 0, "USETMAXREG": 0})}
    if case == "clean":
        chip_smoke.check_attention_build(chip_smoke.ptxas_report(LOG), sass)
        chip_smoke.check_attention_build(chip_smoke.ptxas_report(LOG), "not counted")
        return
    if case == "serialized":
        rep, match = chip_smoke.ptxas_report(LOG + SERIALIZED), "advisories"
    else:
        rep, match = chip_smoke.ptxas_report(LOG), "USETMAXREG"
        sass["functions"]["flash_attn_kernel<64,false>"] = dict(ping_pong, USETMAXREG=0)
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_attention_build(rep, sass)


def test_attention_shapes_cover_every_entry():
    """One list of shapes for the kernel phases and ``--flash-attention``:
    the ten shapes PERF.md's table times, over the three entry points."""
    shapes = chip_smoke.flash_attention_shapes()
    assert list(shapes) == ["serve", "long", "zamba", "zamba_window", "gemma", "vision",
                            "seamless", "chunk", "c64", "chunk_long"]
    kernels = [shape.kernel for shape in shapes.values()]
    assert (kernels.count("flash_attention"), kernels.count("flash_attention_cross"),
            kernels.count("flash_attention_chunk")) == (5, 2, 3)
    assert len({shape.label for shape in shapes.values()}) == 10
