"""Asset I/O tests (obj_reader.zig, png_image.zig, ppm_image.zig)."""

import numpy as np
import pytest

from zraytrace_tpu.io.obj import ObjParseError, read_obj
from zraytrace_tpu.io.png import quantize, read_png, write_png
from zraytrace_tpu.io.ppm import write_ppm
from zraytrace_tpu.scenes import assets_dir


class TestObj:
    def test_man(self):
        # obj_reader.zig stats: Man.obj 1,990 v / 1,969 faces.
        path = assets_dir() / "man" / "Man.obj"
        if not path.exists():
            pytest.skip("asset missing")
        m = read_obj(path)
        assert len(m.vertices) == 1990
        assert m.faces == 1969

    def test_teapot(self):
        # scenes.zig:137-141: teapot 3,644 v / 6,320 f -> 6,320 triangles.
        path = assets_dir() / "teapot" / "teapot.obj"
        if not path.exists():
            pytest.skip("asset missing")
        m = read_obj(path)
        assert len(m.vertices) == 3644
        assert m.faces == 6320
        assert len(m.triangles) == 6320
        # Reference logs the bounding box (scenes.zig:138).
        lo = m.vertices.min(axis=0)
        hi = m.vertices.max(axis=0)
        np.testing.assert_allclose(lo, [-3.0, 0.0, -2.0], atol=1e-2)
        np.testing.assert_allclose(hi, [3.434, 3.15, 2.0], atol=1e-2)

    def test_bunny(self):
        path = assets_dir() / "bunny" / "bunny.obj"
        if not path.exists():
            pytest.skip("asset missing")
        m = read_obj(path)
        assert len(m.vertices) == 2503
        assert m.faces == 4968

    def test_fan_triangulation(self, tmp_path):
        # 5-gon face -> 3 triangles in pattern {0,1,2},{2,3,0},{3,4,0}
        # (obj_reader.zig:85-103).
        p = tmp_path / "pent.obj"
        p.write_text(
            "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0.5 1.5 0\nv 0 1 0\n"
            "f 1 2 3 4 5\n"
        )
        m = read_obj(p)
        np.testing.assert_array_equal(
            m.triangles, [[0, 1, 2], [2, 3, 0], [3, 4, 0]]
        )

    def test_face_vertex_formats(self, tmp_path):
        p = tmp_path / "fmt.obj"
        p.write_text(
            "v 0 0 0\nv 1 0 0\nv 0 1 0\n"
            "vn 0 0 1\n"
            "f 1/1 2/2 3/3\nf 1//1 2//1 3//1\nf 1/1/1 2/1/1 3/1/1\n"
        )
        m = read_obj(p)
        assert len(m.triangles) == 3
        assert len(m.vertex_normals) == 1  # parsed, unused (parity)

    def test_too_many_face_vertices(self, tmp_path):
        p = tmp_path / "bad.obj"
        p.write_text("v 0 0 0\n" * 7 + "f 1 2 3 4 5 6 7\n")
        with pytest.raises(ObjParseError):
            read_obj(p)


class TestPng:
    def test_round_trip(self, tmp_path):
        rng = np.random.default_rng(3)
        img = rng.random((16, 24, 3)).astype(np.float32)
        path = tmp_path / "t.png"
        write_png(path, img)
        back = read_png(path)
        # Quantization to 8 bits then back: within 1/255.
        np.testing.assert_allclose(back, np.floor(img * 255.999) / 255.0, atol=1e-6)

    def test_quantize_matches_reference_clamp(self):
        # png_image.zig:138-140: trunc(clamp(255.999 * c)).
        vals = np.array([[[0.0, 1.0, 0.5], [2.0, -1.0, 0.999]]], np.float32)
        q = quantize(vals)
        np.testing.assert_array_equal(q[0, 0], [0, 255, 127])
        np.testing.assert_array_equal(q[0, 1], [255, 0, 255])

    def test_reads_reference_asset_flipped(self):
        path = assets_dir() / "images" / "earthmap.png"
        if not path.exists():
            pytest.skip("asset missing")
        img = read_png(path)
        assert img.ndim == 3 and img.shape[2] == 3
        assert img.dtype == np.float32
        assert 0.0 <= img.min() and img.max() <= 1.0


def _png(pixels, ftype=0, depth=8, ctype=None, interlace=0):
    """Independent PNG encoder for the decoder tests: applies filter
    ``ftype`` to every scanline (PNG spec §9.2, on the raw bytes)."""
    import struct
    import zlib

    h, w, c = pixels.shape
    ctype = {3: 2, 4: 6}[c] if ctype is None else ctype
    raw = pixels.reshape(h, w * c).astype(np.int64)
    prev = np.zeros(w * c, np.int64)
    rows = []
    for y in range(h):
        x = raw[y]
        left = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if ftype == 0:
            f = x
        elif ftype == 1:
            f = x - left
        elif ftype == 2:
            f = x - prev
        elif ftype == 3:
            f = x - (left + prev) // 2
        else:
            pa = np.abs(prev - upleft)
            pb = np.abs(left - upleft)
            pc = np.abs(left + prev - 2 * upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
            f = x - pred
        rows.append(bytes([ftype]) + (f % 256).astype(np.uint8).tobytes())
        prev = x

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


class TestPngCodec:
    @pytest.mark.parametrize("channels", [3, 4])
    @pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
    def test_decodes_every_filter(self, ftype, channels):
        from zraytrace_tpu.io.png import decode_png

        rng = np.random.default_rng(ftype * 10 + channels)
        # smooth ramps plus noise exercise the predictors' branches
        ramp = np.add.outer(np.arange(9), np.arange(13))[..., None] * 7
        pix = ((ramp + rng.integers(0, 40, (9, 13, channels))) % 256)
        pix = pix.astype(np.uint8)
        np.testing.assert_array_equal(decode_png(_png(pix, ftype)), pix)

    @pytest.mark.parametrize("case", ["depth16", "palette", "gray",
                                      "interlaced", "bad_crc",
                                      "signature"])
    def test_rejects_unsupported(self, case):
        from zraytrace_tpu.io.png import decode_png

        pix = np.zeros((2, 2, 3), np.uint8)
        data = {
            "depth16": lambda: _png(pix, depth=16),
            "palette": lambda: _png(pix, ctype=3),
            "gray": lambda: _png(pix, ctype=0),
            "interlaced": lambda: _png(pix, interlace=1),
            "bad_crc": lambda: _png(pix)[:-5] + b"\x00" + _png(pix)[-4:],
            "signature": lambda: b"GIF89a" + _png(pix)[6:],
        }[case]()
        with pytest.raises(ValueError):
            decode_png(data)

    @pytest.mark.parametrize("name,shape,digest", [
        ("assets/models/images/earthmap.png", (512, 1024, 3),
         "0651e147c9164cf9"),
        ("assets/models/images/nitor-logo-25.png", (439, 1000, 4),
         "045522c6b6be0f3d"),
        ("showcase/goat_class_256x256_64spp.png", (256, 256, 3),
         "38df1226620759f4"),
        ("showcase/teapotAndBall_700x700_100spp.png", (700, 700, 3),
         "54b6a0bbf7cd8def"),
    ])
    def test_repo_pngs_decode_to_golden_pixels(self, name, shape, digest):
        """Digests of the decoded pixels of the repo's own images (these
        files use every filter type; the digests equal those of Pillow's
        decoding of the same files)."""
        import hashlib
        from pathlib import Path

        from zraytrace_tpu.io.png import decode_png

        path = Path(__file__).resolve().parent.parent / name
        pix = decode_png(path.read_bytes())
        assert pix.shape == shape
        assert hashlib.sha256(pix.tobytes()).hexdigest()[:16] == digest

    def test_encoder_writes_rgb_bottom_up(self, tmp_path):
        from zraytrace_tpu.io.png import decode_png

        img = np.zeros((2, 3, 3), np.float32)
        img[0, 0] = (1.0, 0.0, 0.0)  # row 0 = bottom
        path = tmp_path / "o.png"
        write_png(path, img)
        pix = decode_png(path.read_bytes())
        assert pix.shape == (2, 3, 3)
        np.testing.assert_array_equal(pix[1, 0], [255, 0, 0])
        np.testing.assert_array_equal(pix[0, 0], [0, 0, 0])

    def test_read_drops_alpha(self, tmp_path):
        pix = np.full((2, 2, 4), 200, np.uint8)
        pix[..., 3] = 7
        path = tmp_path / "a.png"
        path.write_bytes(_png(pix, 4))
        img = read_png(path)
        assert img.shape == (2, 2, 3)
        np.testing.assert_allclose(img, 200 / 255.0)


class TestPpm:
    def test_reference_byte_size_anchor(self, tmp_path):
        # ppm_image.zig:70-83: 10x10 black image with the reference's
        # filename string is exactly 1,446 bytes.
        img = np.zeros((10, 10, 3), np.float32)
        path = tmp_path / "img-file.ppm"
        write_ppm(path, img, header_filename="./target/img-file.ppm")
        assert path.stat().st_size == 1446

    def test_header_and_order(self, tmp_path):
        img = np.zeros((2, 2, 3), np.float32)
        img[0, 0] = (1.0, 0.0, 0.0)  # bottom-left pixel
        path = tmp_path / "o.ppm"
        write_ppm(path, img)
        text = path.read_text()
        assert text.startswith("P3\n")
        lines = text.splitlines()
        data = lines[lines.index("# RGB triplets") + 1 :]
        assert len(data) == 2
        # bottom row (with the red pixel at x=0) is written last
        # (ppm_image.zig:37)
        assert data[-1].split()[:3] == ["255", "0", "0"]
        assert data[0].split()[:3] == ["0", "0", "0"]
