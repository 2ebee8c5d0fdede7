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
