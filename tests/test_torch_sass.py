"""``libstacker_tpu_torch/utils/sass.py`` on a hand-made SASS listing in
``cuobjdump -sass``'s format: the innermost loop, its main path (the most
global loads, then the most MUFU, then the fewest instructions; a call
out of the loop is not followed) and the counts by class."""

import pytest

from libstacker_tpu_torch.utils import sass

_LISTING = """
	code for sm_90a
		Function : _Z5otherv
        /*0000*/                   EXIT ;
		Function : _Z6kernelPKhPf
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS.128 R4, [UR4] ;
        /*0020*/                   FSETP.NEU.AND P0, PT, R4, RZ, PT ;
        /*0030*/              @!P0 BRA 0x90 ;
        /*0040*/                   MUFU.RCP R5, R4 ;
        /*0050*/                   LDG.E.U8.CONSTANT R6, desc[UR6][R2.64] ;
        /*0060*/                   I2F.U16 R6, R6 ;
        /*0070*/                   FFMA R7, R6, R5, R7 ;
        /*0080*/                   BRA 0xc0 ;
        /*0090*/                   MOV R17, R4 ;
        /*00a0*/                   CALL.REL.NOINC 0x200 ;
        /*00b0*/                   FADD R7, R7, R17 ;
        /*00c0*/                   IADD3 R8, R8, 0x1, RZ ;
        /*00d0*/                   ISETP.NE.AND P1, PT, R8, R9, PT ;
        /*00e0*/               @P1 BRA 0x10 ;
        /*00f0*/               @P2 BRA 0x0 ;
        /*0100*/                   STG.E desc[UR6][R10.64], R7 ;
        /*0110*/                   EXIT ;
        /*0200*/                   MUFU.RCP R17, R17 ;
        /*0210*/                   RET.REL.NODEC R20 0x0 ;
"""


def _labelled(listing: str) -> str:
    """The same listing with label lines and `(.L_x_N) branch targets,
    as newer cuobjdump prints them."""
    import re

    targets = sorted({int(t, 16) for t in re.findall(r"BRA (0x[0-9a-f]+)",
                                                     listing)})
    out = []
    for line in listing.splitlines():
        m = re.search(r"/\*([0-9a-f]{4})\*/", line)
        if m and int(m.group(1), 16) in targets:
            out.append(f".L_x_{int(m.group(1), 16)}:")
        out.append(re.sub(r"BRA (0x[0-9a-f]+)",
                          lambda t: f"BRA `(.L_x_{int(t.group(1), 16)})",
                          line))
    return "\n".join(out)


def test_functions_split():
    funcs = sass.functions(_LISTING)
    assert sorted(funcs) == ["_Z5otherv", "_Z6kernelPKhPf"]
    assert sass.loop_classes(funcs["_Z5otherv"]) is None


@pytest.mark.parametrize("form", ["addresses", "labels"])
def test_main_path_counts(form):
    listing = _LISTING if form == "addresses" else _labelled(_LISTING)
    found = sass.loop_classes(sass.functions(listing)["_Z6kernelPKhPf"])
    # the inner loop 0x10..0xe0, not the outer one that holds it
    assert found["static"] == 14
    # LDS FSETP BRA | MUFU LDG I2F FFMA BRA | IADD3 ISETP BRA
    assert found["counts"] == {"fp32": 2, "conv": 2, "mem": 2, "int": 2,
                               "branch": 3}
    assert found["ops"]["LDG.E.U8.CONSTANT"] == 1
    assert "CALL.REL.NOINC" not in found["ops"]
    assert found["pixel_frames"] == found["mufu"] == 1
    assert found["per_pixel_total"] == 11
    assert "11.0 instructions a pixel-frame" in sass.fmt(found)
    # two pixel-frames an iteration halve the per-pixel counts; the taps
    # come first, so an affine instance's path still takes the load
    two = sass.loop_classes(sass.functions(listing)["_Z6kernelPKhPf"], 2)
    assert two["per_pixel_total"] == 5.5
    affine = sass.loop_classes(sass.functions(listing)["_Z6kernelPKhPf"],
                               homography=False)
    assert affine["counts"] == found["counts"]


def test_classes():
    assert [sass.classify(op) for op in
            ("FMUL", "FRND", "I2F", "MUFU", "LDS", "ULDC", "LOP3", "IMAD",
             "BSSY", "CALL")] == ["fp32", "conv", "conv", "conv", "mem", "mem",
                                  "int", "int", "branch", "branch"]
    assert sass.fmt(None) == "no SASS loop found"


# a kernel with no loop (one thread an output value): an early exit, a
# branch to the division's slow path, then the taps and the store
_FLAT = """
		Function : _Z4flatPKfPf
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   ISETP.GE.AND P0, PT, R0, c[0x0][0x170], PT ;
        /*0020*/               @P0 EXIT ;
        /*0030*/                   FFMA R2, R0, R4, R5 ;
        /*0040*/                   FSETP.GEU.AND P1, PT, |R2|, 1e-30, PT ;
        /*0050*/              @!P1 BRA 0xa0 ;
        /*0060*/                   MUFU.RCP R3, R2 ;
        /*0070*/                   LDG.E R6, desc[UR4][R8.64] ;
        /*0080*/                   LDG.E R7, desc[UR4][R8.64+0x4] ;
        /*0090*/                   BRA 0xc0 ;
        /*00a0*/                   CALL.REL.NOINC 0x200 ;
        /*00b0*/                   LDG.E R6, desc[UR4][R8.64] ;
        /*00c0*/                   FADD R7, R6, R7 ;
        /*00d0*/                   STG.E desc[UR4][R10.64], R7 ;
        /*00e0*/                   EXIT ;
        /*00f0*/                   BRA 0xf0 ;
        /*0200*/                   MUFU.RCP R3, R3 ;
        /*0210*/                   RET.REL.NODEC R20 0x0 ;
"""


@pytest.mark.parametrize("form", ["addresses", "labels"])
def test_loop_free_body(form):
    """A kernel with no loop: no loop counts, and the body's main path
    runs from the first instruction to the last EXIT through the taps,
    past the early exit and the slow path."""
    listing = _FLAT if form == "addresses" else _labelled(_FLAT)
    text = sass.functions(listing)["_Z4flatPKfPf"]
    # `BRA 0xf0` is the compiler's self-loop after the last EXIT
    found = sass.body_classes(text)
    # S2R ISETP EXIT | FFMA FSETP BRA | MUFU LDG LDG BRA | FADD STG EXIT
    assert found["counts"] == {"fp32": 3, "conv": 1, "mem": 3, "int": 2,
                               "branch": 4}
    assert found["ops"]["LDG.E"] == 2 and found["mufu"] == 1
    assert "CALL.REL.NOINC" not in found["ops"]
    assert found["per_pixel_total"] == 13
    assert sass.body_classes(text, 2)["per_pixel_total"] == 6.5


def test_path_by_mufu():
    """Two paths with the same loads: ``homography`` picks the one with
    a MUFU a pixel, else the one with none (B5's slot that reuses the
    previous slot's coordinates)."""
    listing = """
		Function : _Z5slotsv
        /*0000*/                   LDS R4, [UR4] ;
        /*0010*/                   ISETP.NE.AND P0, PT, R4, RZ, PT ;
        /*0020*/               @P0 BRA 0x50 ;
        /*0030*/                   FMUL R5, R4, R4 ;
        /*0040*/                   MUFU.RCP R5, R5 ;
        /*0050*/                   LDG.E R6, desc[UR6][R2.64] ;
        /*0060*/                   FFMA R7, R6, R5, R7 ;
        /*0070*/                   STG.E desc[UR6][R10.64], R7 ;
        /*0080*/                   ISETP.NE.AND P1, PT, R8, R9, PT ;
        /*0090*/               @P1 BRA 0x0 ;
        /*00a0*/                   EXIT ;
"""
    text = sass.functions(listing)["_Z5slotsv"]
    fresh = sass.loop_classes(text, 1)
    shared = sass.loop_classes(text, 1, homography=False)
    assert fresh["mufu"] == 1 and fresh["total"] == 10
    assert shared["mufu"] == 0 and shared["total"] == 8
    # the body's path is one pass: the fresh iteration, then the EXIT
    assert sass.body_classes(text)["total"] == fresh["total"] + 1


def test_longest_path():
    """A body whose threads share one path but for a guarded task (B3d's
    blurring threads): ``longest`` takes the guarded work, the default
    skips it; with no MUFU wanted, the path through the MUFU branch is
    not taken either way."""
    listing = """
		Function : _Z5blurv
        /*0000*/                   LDG.E R4, desc[UR6][R2.64] ;
        /*0010*/                   ISETP.GE.AND P0, PT, R0, 0x58, PT ;
        /*0020*/               @P0 BRA 0x60 ;
        /*0030*/                   LDS.128 R8, [R5] ;
        /*0040*/                   FMUL R8, R8, c[0x0][0x160] ;
        /*0050*/                   STS.128 [R6], R8 ;
        /*0060*/                   ISETP.NE.AND P1, PT, R7, 0x3, PT ;
        /*0070*/               @P1 BRA 0xa0 ;
        /*0080*/                   MUFU.RCP R9, R4 ;
        /*0090*/                   FMUL R9, R9, R4 ;
        /*00a0*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*00b0*/                   EXIT ;
"""
    text = sass.functions(listing)["_Z5blurv"]
    busiest = sass.body_classes(text, homography=False, longest=True)
    idle = sass.body_classes(text, homography=False)
    assert busiest["mufu"] == 0 and idle["mufu"] == 0
    assert busiest["total"] == 10 and idle["total"] == 7
    assert "STS.128" in busiest["ops"] and "STS.128" not in idle["ops"]


def test_kernel_loop_whole_body(monkeypatch):
    """``kernel_loop`` with ``whole`` on a loop-free kernel (B5's frames
    form): the main path by default the busiest, with ``longest`` False
    the fast one, past the slow path's CALL."""
    listing = _labelled(_FLAT)
    monkeypatch.setattr(sass, "_library_functions",
                        lambda lib: sass.functions(listing))
    main = sass.kernel_loop("lib.so", "flat", 2, whole=True, longest=False)
    assert main["kernel"] == "_Z4flatPKfPf"
    assert main["per_pixel_total"] == 6.5 and main["mufu"] == 1
    busiest = sass.kernel_loop("lib.so", "flat", 2, whole=True)
    assert busiest["total"] >= main["total"]
    assert sass.kernel_loop("lib.so", "absent", whole=True) is None
