"""Hostile-input fuzzing for the three binary parsers.

The reference survives arbitrary user files because its reader throws and
the app catches per-load (`main.cpp:692-698`, throw at
`reader/pmx_reader_impl.inl:96-99`). Our contract is stricter and typed:
every malformed input — truncated anywhere, byte-corrupted, forged counts,
invalid index widths — must either parse (corruption can land on benign
payload bytes) or raise exactly `utils.io.ParseError`. Never a bare
struct.error / IndexError / numpy ValueError / MemoryError / hang.
"""

import numpy as np
import pytest

from simple_mmd_renderer.formats.pmd import parse_pmd
from simple_mmd_renderer.formats.pmx import parse_pmx
from simple_mmd_renderer.formats.vmd import parse_vmd
from simple_mmd_renderer.utils.io import BinReader, ParseError

from wild_assets import build_wild_pmd, build_wild_pmx, build_wild_vmd

PARSERS = {
    "pmx": (parse_pmx, build_wild_pmx(seed=0)),
    "pmd": (parse_pmd, build_wild_pmd(seed=1)),
    "vmd": (parse_vmd, build_wild_vmd(seed=2)),
}


def _must_be_typed(parse, data):
    """Parse `data`; success and ParseError are the only legal outcomes."""
    try:
        parse(data)
    except ParseError:
        pass
    # anything else (struct.error, IndexError, np ValueError...) propagates
    # and fails the test with the offending exception as the message


@pytest.mark.parametrize("fmt", list(PARSERS))
def test_truncation_at_every_region(fmt):
    """Slicing the file at 200 deterministic offsets never escapes the
    typed-error contract (VMD's optional camera/light tails may succeed
    with partial data — that mirrors the reference reader stopping at
    end-of-stream)."""
    parse, data = PARSERS[fmt]
    parse(data)  # the full image must parse
    rng = np.random.default_rng(1234)
    cuts = sorted(set(rng.integers(0, len(data), 200).tolist())
                  | {0, 1, 2, 3, 4, len(data) // 2, len(data) - 1})
    for cut in cuts:
        _must_be_typed(parse, data[:cut])


@pytest.mark.parametrize("fmt", list(PARSERS))
def test_byte_corruption(fmt):
    """Random single/multi-byte corruption at 200 deterministic sites:
    either parses (corruption on benign payload) or raises ParseError."""
    parse, data = PARSERS[fmt]
    rng = np.random.default_rng(4321)
    buf = bytearray(data)
    for _ in range(200):
        k = int(rng.integers(1, 5))
        sites = rng.integers(0, len(buf), k)
        olds = [(int(s), buf[int(s)]) for s in sites]
        for s, _ in olds:
            buf[s] = int(rng.integers(0, 256))
        _must_be_typed(parse, bytes(buf))
        for s, old in olds:  # restore: each round corrupts fresh
            buf[s] = old


def test_pmx_truncation_python_fallback(monkeypatch):
    """The pure-python vertex loop (used when the native lib is absent)
    holds the same contract as native/pmx_fast.cpp."""
    import simple_mmd_renderer.native as native_mod
    monkeypatch.setattr(native_mod, "get_lib",
                        lambda: (_ for _ in ()).throw(OSError("no lib")))
    data = PARSERS["pmx"][1]
    parse_pmx(data)  # full image parses through the fallback too
    rng = np.random.default_rng(77)
    for cut in sorted(set(rng.integers(0, len(data), 60).tolist())):
        _must_be_typed(parse_pmx, data[:cut])


def _pmx_header(sz=2):
    """Minimal valid PMX header + globals + 4 empty text fields."""
    return (b"PMX " + np.float32(2.0).tobytes() + bytes([8, 0, 0])
            + bytes([sz] * 6) + b"\x00\x00\x00\x00" * 4)


class TestForgedCounts:
    def test_huge_vertex_count_rejected_before_allocation(self):
        # a forged 2^30 vertex count must raise, not drive a ~100 GB np.empty
        data = _pmx_header() + np.int32(1 << 30).tobytes()
        with pytest.raises(ParseError, match="vertex count"):
            parse_pmx(data)

    def test_negative_vertex_count(self):
        data = _pmx_header() + np.int32(-5).tobytes()
        with pytest.raises(ParseError, match="negative"):
            parse_pmx(data)

    def test_invalid_index_size(self):
        data = bytearray(_pmx_header())
        data[11] = 3  # vertex index size 3 (must be 1/2/4)
        with pytest.raises(ParseError, match="index size"):
            parse_pmx(bytes(data))

    def test_triangle_index_past_vertex_count(self):
        full = PARSERS["pmx"][1]
        m = parse_pmx(full)
        # wild asset uses u16 vertex indices right after the vertex block;
        # rebuild a tiny hand-rolled file instead: 0 verts, 3 indices
        data = (_pmx_header() + np.int32(0).tobytes()           # 0 vertices
                + np.int32(3).tobytes()                          # 3 indices
                + np.array([0, 1, 2], "<u2").tobytes()
                )
        with pytest.raises(ParseError, match="triangle index"):
            parse_pmx(data)
        assert m.triangles.size  # sanity: the wild asset has real faces

    def test_vmd_forged_bone_count(self):
        data = bytes(PARSERS["vmd"][1])
        forged = data[:50] + np.uint32(1 << 31).tobytes() + data[54:]
        with pytest.raises(ParseError, match="truncated"):
            parse_vmd(forged)

    def test_pmd_forged_face_vertex_count(self):
        # face morph vnum far beyond the remaining bytes must raise before
        # sizing the allocation
        with pytest.raises(ParseError):
            data = PARSERS["pmd"][1]
            m = bytearray(data)
            # find the face-morph section is format-dependent; simplest
            # robust forgery: truncate to just past the header and splice a
            # huge u32 where counts live — covered more precisely by the
            # corruption fuzz; here assert the guard exists via a direct
            # synthetic: header + 0 verts + 0 idx + 0 mats + 0 bones +
            # 0 iks + 1 face with vnum=2^30
            synth = (b"Pmd" + np.float32(1.0).tobytes()
                     + b"\x00" * 20 + b"\x00" * 256
                     + np.uint32(0).tobytes()      # vertices
                     + np.uint32(0).tobytes()      # indices
                     + np.uint32(0).tobytes()      # materials
                     + np.uint16(0).tobytes()      # bones
                     + np.uint16(0).tobytes()      # iks
                     + np.uint16(1).tobytes()      # 1 face morph
                     + b"\x00" * 20                # name
                     + np.uint32(1 << 30).tobytes()  # forged vnum
                     + b"\x00")                    # ftype
            parse_pmd(synth)

    def test_binreader_typed_errors(self):
        r = BinReader(b"\x01\x02")
        with pytest.raises(ParseError, match="truncated"):
            r.read("i", "field")
        with pytest.raises(ParseError, match="negative"):
            r.read_bytes(-1, "field")
        with pytest.raises(ParseError, match="invalid index width"):
            r.read_index(3, "field")
        with pytest.raises(ParseError, match="truncated"):
            r.read_array(np.float32, 10, "field")
        err = None
        try:
            BinReader(b"").read("f", "position")
        except ParseError as e:
            err = e
        assert err.offset == 0 and err.field == "position"

    def test_native_rc_overrun(self):
        """The C parser's rc=-1 (overrun) surfaces as ParseError: a valid
        header claiming 4 vertices over 10 bytes of vertex data."""
        try:
            from simple_mmd_renderer.native import get_lib
            get_lib()
        except Exception:
            pytest.skip("native lib unavailable")
        data = (_pmx_header() + np.int32(4).tobytes() + b"\x00" * 10
                + b"\xff" * 160)  # plausible remaining-byte budget
        with pytest.raises(ParseError):
            parse_pmx(data)
