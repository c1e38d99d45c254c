"""The port's image input path on the CPU: ``utils/collate.letterbox_image``
against the JAX one (cv2), ``native`` decode against PIL and the JAX
``native``, the choice of the native route, and ``EmbeddingService.stream``
over JPEG files against ``embed_batch`` on the same decoded batches."""

import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from pets_face_recognition_tpu import native as j_native
from pets_face_recognition_tpu.utils.collate import letterbox_image as j_letterbox
from pets_face_recognition_tpu_torch import native, serving
from pets_face_recognition_tpu_torch.models.embedder import resnet50_embedder
from pets_face_recognition_tpu_torch.models.rcnn import keypointrcnn_resnet50_fpn
from pets_face_recognition_tpu_torch.utils.collate import letterbox_image
from pets_face_recognition_tpu_torch.weights import init_random_

torch.set_num_threads(1)

CORPUS = (Path(__file__).resolve().parent.parent / "pets_face_recognition_tpu_torch"
          / "testdata" / "kashtanka_test")
VARIANTS = CORPUS.parent / "jpeg_variants"   # 4:4:4, 4:2:2, 4:2:0, gray, progressive


def corpus_jpegs():
    return sorted(CORPUS.rglob("*.jpg"))


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """Noise JPEGs of odd shapes, a grayscale one and a 4:4:4 one."""
    root = tmp_path_factory.mktemp("jpegs")
    rng = np.random.RandomState(3)
    paths = []
    for i, (h, w) in enumerate([(480, 640), (333, 217), (64, 64), (100, 300)]):
        p = root / f"{i}.jpg"
        Image.fromarray(rng.randint(0, 255, (h, w, 3)).astype(np.uint8)).save(p, quality=92)
        paths.append(p)
    p = root / "gray.jpg"
    Image.fromarray(rng.randint(0, 255, (90, 70)).astype(np.uint8)).save(p, quality=85)
    paths.append(p)
    p = root / "444.jpg"
    Image.fromarray(rng.randint(0, 255, (50, 80, 3)).astype(np.uint8)).save(
        p, quality=95, subsampling=0)
    paths.append(p)
    return paths


# cv2 resizes uint8 images with 11-bit fixed-point weights and the port in
# float32, so a resized pixel may differ by 1; geometry must be equal
@pytest.mark.parametrize("shape,size", [((480, 640), (320, 320)), ((333, 217), (320, 320)),
                                        ((64, 64), (320, 320)), ((100, 300), (128, 200)),
                                        ((320, 320), (320, 320)), ((200, 320), (320, 320)),
                                        ((256, 192), (128, 128))])
def test_letterbox_matches_jax(shape, size):
    img = np.random.RandomState(sum(shape)).randint(0, 256, (*shape, 3)).astype(np.uint8)
    want, want_scale, want_pads = j_letterbox(img, size)
    got, scale, pads = letterbox_image(torch.from_numpy(img), size)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (*size, 3)
    assert scale == want_scale and pads == want_pads
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1
    nh, nw = round(shape[0] * scale), round(shape[1] * scale)
    if (nh, nw) == shape:   # scale 1 or an unresized side: a copy
        np.testing.assert_array_equal(got.numpy(), want)
    if shape == (256, 192):  # an exact 2x downscale: no rounding to differ in
        np.testing.assert_array_equal(got.numpy(), want)


def test_letterbox_float_matches_jax():
    """Float images stay float: cv2 and PyTorch interpolate in float32."""
    img = np.random.RandomState(0).rand(150, 90, 3).astype(np.float32)
    want, want_scale, want_pads = j_letterbox(img, (128, 128))
    got, scale, pads = letterbox_image(torch.from_numpy(img), (128, 128))
    assert got.dtype == torch.float32 and (scale, pads) == (want_scale, want_pads)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_route_here_is_libjpeg_built_into_the_package():
    """This host has g++ and jpeglib.h: the libjpeg route, built into the
    git-ignored ``_build/`` under a content hash."""
    assert native.route() == "libjpeg" and native.is_available()
    path = native.build()
    assert path.parent.name == "_build" and path.name.startswith("libpfr_native_libjpeg_")
    assert path == native.library_path("libjpeg")


def test_route_is_chosen_by_what_is_installed(monkeypatch, tmp_path):
    """libjpeg's header first, else the toolkit's nvjpeg.h, else none; the
    nvJPEG build links nvJPEG and a static CUDA runtime."""
    inc = tmp_path / "cuda" / "include"
    inc.mkdir(parents=True)
    monkeypatch.setattr(native, "_include_dirs", lambda: [tmp_path / "none"])
    monkeypatch.setattr(native, "cuda_root", lambda: tmp_path / "cuda")
    native.route.cache_clear()
    try:
        assert native.route() is None and not native.is_available()
        native.route.cache_clear()
        (inc / "nvjpeg.h").write_text("")
        assert native.route() == "nvjpeg"
        cmd = native.build_command("nvjpeg", tmp_path / "lib.so")
        assert "-lnvjpeg" in cmd and "-lcudart_static" in cmd and f"-I{inc}" in cmd
        assert str(native.HERE / "pfr_nvjpeg.cpp") in cmd
        native.route.cache_clear()
        monkeypatch.setattr(native.shutil, "which", lambda name: None)
        assert native.route() is None
        with pytest.raises(RuntimeError, match="no native JPEG route"):
            native.build()
    finally:
        native.route.cache_clear()


def test_both_routes_share_the_abi_and_the_letterbox():
    for name in ("pfr_native.cpp", "pfr_nvjpeg.cpp"):
        text = (native.HERE / name).read_text()
        assert '#include "pfr_common.h"' in text
        assert "int pfr_decode_batch(const char** paths, int n, uint8_t* out" in text
        assert "int pfr_decode_single(const char* path, uint8_t* out" in text
        assert "pfr::decode_batch(" in text


@pytest.mark.parametrize("which", ["corpus", "odd", "variants"])
def test_decode_single_is_bit_equal_to_pil(which, jpegs):
    paths = {"corpus": corpus_jpegs(), "odd": jpegs,
             "variants": sorted(VARIANTS.glob("*.jpg"))}[which]
    assert len(paths) >= 6
    for p in paths:
        got = native.decode_single(p)
        want = np.array(Image.open(p).convert("RGB"))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=str(p))


def test_decode_single_flags_a_bad_file(tmp_path):
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg")
    assert native.decode_single(bad) is None
    assert native.decode_single(tmp_path / "missing.jpg") is None


@pytest.mark.parametrize("size", [(320, 320), (128, 200)])
def test_decode_batch_matches_jax_native(size, jpegs, tmp_path):
    """Bit-equal images, scales, pads and flags, failures included."""
    (tmp_path / "garbage.jpg").write_bytes(b"not a jpeg")
    paths = (corpus_jpegs()[:4] + list(jpegs) + sorted(VARIANTS.glob("*.jpg"))
             + [tmp_path / "nope.jpg", tmp_path / "garbage.jpg"])
    got = native.decode_batch(paths, size, num_threads=3)
    want = j_native.decode_batch(paths, size)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert list(got[1][-2:]) == [False, False] and got[1][:-2].all()
    assert got[0][-1].sum() == 0


def test_decode_batch_host_native_and_pil(monkeypatch, jpegs):
    """The native route for JPEGs; PIL with the port's letterbox where no
    route is installed: equal for unresized images, within 1 otherwise."""
    paths = corpus_jpegs()[:3] + list(jpegs[:2])
    got = serving._decode_batch_host(paths, (320, 320))
    for g, w in zip(got, native.decode_batch(paths, (320, 320))):
        np.testing.assert_array_equal(g, w)
    monkeypatch.setattr(native, "is_available", lambda: False)
    pil = serving._decode_batch_host(paths, (320, 320))
    np.testing.assert_array_equal(pil[0][:3], got[0][:3])
    assert np.abs(pil[0].astype(int) - got[0].astype(int)).max() <= 1
    for g, w in zip(pil[1:], got[1:]):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def service():
    """Cut-down models (one block a stage), 128 x 128 input, batch 2."""
    det = init_random_(keypointrcnn_resnet50_fpn(stage_sizes=(1, 1, 1, 1),
                                                 rpn_pre_nms_top_n_test=32,
                                                 rpn_post_nms_top_n_test=8), 0).eval()
    emb = init_random_(resnet50_embedder(512, stage_sizes=(1, 1, 1, 1)), 1).eval()
    return serving.EmbeddingService(det, emb, score_thr=0.0, device="cpu", batch_size=2,
                                    input_size=(128, 128), prefetch=1)


def test_stream_matches_embed_batch(service, tmp_path):
    """Five files (one undecodable) in batches of two, the tail padded with
    its last path: the same embeddings and validity as ``embed_batch`` on
    the decoded batches, in order."""
    (tmp_path / "bad.jpg").write_bytes(b"x")
    paths = corpus_jpegs()[:2] + [tmp_path / "bad.jpg"] + corpus_jpegs()[2:4]
    out = list(service.stream(paths))
    assert [len(c) for c, _, _ in out] == [2, 2, 1]
    assert [p for c, _, _ in out for p in c] == [Path(p) for p in paths]
    for i, (chunk, emb, valid) in enumerate(out):
        padded = chunk + [chunk[-1]] * (2 - len(chunk))
        images, ok, _, _ = serving._decode_batch_host(padded, (128, 128))
        want_e, want_v = service.embed_batch(torch.from_numpy(images), torch.from_numpy(ok))
        np.testing.assert_array_equal(valid, want_v.numpy()[:len(chunk)])
        np.testing.assert_array_equal(emb, want_e.numpy()[:len(chunk)])
    assert not out[1][2][0], "the undecodable file must come back invalid"
    emb, valid = service.embed_paths(paths)
    assert emb.shape == (5, 512) and valid.shape == (5,)
    np.testing.assert_array_equal(emb, np.concatenate([e for _, e, _ in out]))


def test_stream_stops_its_producer_when_closed(service):
    paths = corpus_jpegs()[:8]
    gen = service.stream(paths)
    next(gen)
    gen.close()
    assert not [t for t in threading.enumerate() if t.name == "decode"]
    assert service.embed_paths([])[0].shape == (0, 512)


# libjpeg's raw planes (raw_data_out) through pfr_common.h::ycc_to_rgb, the
# colour rebuild of the nvJPEG route, against libjpeg's own RGB decode
YCC_HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include <jpeglib.h>
#include "pfr_common.h"

static std::vector<uint8_t> rgb(const char* path, int* w, int* h) {
  FILE* f = std::fopen(path, "rb");
  jpeg_decompress_struct ci; jpeg_error_mgr je; ci.err = jpeg_std_error(&je);
  jpeg_create_decompress(&ci); jpeg_stdio_src(&ci, f); jpeg_read_header(&ci, TRUE);
  ci.out_color_space = JCS_RGB; jpeg_start_decompress(&ci);
  *w = ci.output_width; *h = ci.output_height;
  std::vector<uint8_t> px(static_cast<size_t>(*w) * *h * 3);
  while (ci.output_scanline < ci.output_height) {
    uint8_t* row = px.data() + static_cast<size_t>(ci.output_scanline) * *w * 3;
    jpeg_read_scanlines(&ci, &row, 1);
  }
  jpeg_finish_decompress(&ci); jpeg_destroy_decompress(&ci); std::fclose(f);
  return px;
}

int main(int argc, char** argv) {
  int worst = 0;
  for (int a = 1; a < argc; ++a) {
    int w, h;
    std::vector<uint8_t> want = rgb(argv[a], &w, &h);
    FILE* f = std::fopen(argv[a], "rb");
    jpeg_decompress_struct ci; jpeg_error_mgr je; ci.err = jpeg_std_error(&je);
    jpeg_create_decompress(&ci); jpeg_stdio_src(&ci, f); jpeg_read_header(&ci, TRUE);
    ci.raw_data_out = TRUE; jpeg_start_decompress(&ci);
    const int nc = ci.num_components;
    std::vector<std::vector<uint8_t>> planes(nc);
    std::vector<std::vector<JSAMPROW>> rows(nc);
    for (int c = 0; c < nc; ++c)
      planes[c].resize(static_cast<size_t>(ci.comp_info[c].width_in_blocks) * DCTSIZE *
                       (ci.comp_info[c].height_in_blocks * DCTSIZE + 64));
    for (int done = 0; ci.output_scanline < ci.output_height;
         done += ci.max_v_samp_factor * DCTSIZE) {
      JSAMPARRAY arrays[4];
      for (int c = 0; c < nc; ++c) {
        const jpeg_component_info& cp = ci.comp_info[c];
        const int stride = cp.width_in_blocks * DCTSIZE;
        const int base = done / ci.max_v_samp_factor * cp.v_samp_factor;
        rows[c].resize(cp.v_samp_factor * DCTSIZE);
        for (size_t i = 0; i < rows[c].size(); ++i)
          rows[c][i] = planes[c].data() + static_cast<size_t>(base + i) * stride;
        arrays[c] = rows[c].data();
      }
      jpeg_read_raw_data(&ci, arrays, ci.max_v_samp_factor * DCTSIZE);
    }
    pfr::Plane p[3];
    for (int c = 0; c < nc; ++c) {
      const jpeg_component_info& cp = ci.comp_info[c];
      p[c] = pfr::Plane{planes[c].data(), static_cast<int>(cp.downsampled_width),
                        static_cast<int>(cp.downsampled_height),
                        static_cast<size_t>(cp.width_in_blocks) * DCTSIZE};
    }
    std::vector<uint8_t> got(want.size());
    const int hf = nc > 1 ? ci.max_h_samp_factor / ci.comp_info[1].h_samp_factor : 1;
    const int vf = nc > 1 ? ci.max_v_samp_factor / ci.comp_info[1].v_samp_factor : 1;
    pfr::ycc_to_rgb(p[0], nc > 1 ? &p[1] : nullptr, nc > 1 ? &p[2] : nullptr, hf, vf, w, h,
                    got.data());
    for (size_t i = 0; i < got.size(); ++i)
      worst = std::max(worst, std::abs(static_cast<int>(got[i]) - static_cast<int>(want[i])));
    std::printf("%s %dx%d h%dv%d\n", argv[a], w, h, hf, vf);
    jpeg_abort_decompress(&ci); jpeg_destroy_decompress(&ci); std::fclose(f);
  }
  std::printf("worst %d\n", worst);
  return 0;
}
"""


def test_ycc_rebuild_is_libjpegs(jpegs, tmp_path):
    """The nvJPEG route's colour rebuild (upsampling and YCbCr -> RGB) gives
    libjpeg's RGB to the bit from libjpeg's own planes, at 4:4:4, 4:2:2 and
    4:2:0 (h2v1, h2v2 fancy and their replication below 3 columns), gray and
    progressive, odd sizes down to 1 x 1; so on the card only the IDCTs can
    differ."""
    import subprocess

    src = tmp_path / "ycc.cpp"
    src.write_text(YCC_HARNESS)
    exe = tmp_path / "ycc"
    subprocess.run(["g++", "-O2", "-std=c++17", f"-I{native.HERE}", str(src), "-o", str(exe),
                    "-ljpeg"], check=True, capture_output=True, timeout=120)
    rng = np.random.RandomState(9)
    tiny = []
    for i, (h, w) in enumerate([(1, 1), (5, 3), (17, 2), (2, 9), (33, 47)]):
        for ss in (0, 1, 2):
            p = tmp_path / f"tiny{i}_{ss}.jpg"
            Image.fromarray(rng.randint(0, 255, (h, w, 3)).astype(np.uint8)).save(
                p, quality=90, subsampling=ss)
            tiny.append(p)
    paths = corpus_jpegs()[:4] + list(jpegs) + sorted(VARIANTS.glob("*.jpg")) + tiny
    out = subprocess.run([str(exe), *map(str, paths)], check=True, capture_output=True,
                         text=True, timeout=120).stdout.splitlines()
    assert {line.split()[-1] for line in out[:-1]} >= {"h1v1", "h2v1", "h2v2"}
    assert out[-1] == "worst 0", out
