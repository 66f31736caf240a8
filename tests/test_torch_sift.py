"""The port's SIFT, stage by stage and with each of its options, against
sba_tpu on the CPU (the front-end commands are in
tests/test_torch_two_view.py).

sba_tpu's SIFT runs with x64 off, as its `extract_sift_batch` runs it.
Both packages see the same images. Keypoints are compared as a share of
rows: a float32 rounding in the blur moves a refined extremum by about
1e-3 px, in sba_tpu against itself too (`test_extract_sift_final` measures
that on a one-ulp change of the input).
"""

import jax
import numpy as np
import pytest
import torch

from sba_tpu.features import sift as js
from sba_tpu_torch.features import sift as ts

T = torch.as_tensor
H, W = 120, 160
OPT_J = js.SiftExtractionOptions(max_num_features=256)
OPT_T = ts.SiftExtractionOptions(max_num_features=256)


def blob_image(h, w, centers, sigmas, seed=0):
    """tests/test_features.py's blob image: Gaussian blobs + tiny noise."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    img = np.zeros((h, w), np.float32)
    for (cy, cx), s in zip(centers, sigmas):
        img += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s ** 2))
    rng = np.random.default_rng(seed)
    img += 0.01 * rng.standard_normal((h, w)).astype(np.float32)
    return np.clip(img, 0, 1).astype(np.float32)


def textured_image():
    from sba_tpu_torch.utils.render import render_scene

    sc = render_scene(num_images=1, image_size=(W, H), device="cpu", seed=3)
    return sc["images"][0].astype(np.float32) / 255.0


IMAGES = {
    "textured": textured_image,
    "blob": lambda: blob_image(H, W, [(40, 40), (40, 100), (90, 60),
                                      (80, 130)], [3.0, 4.0, 3.5, 5.0]),
}


def _jax_pyramid(img):
    pre = np.sqrt(max(OPT_J.sigma0 ** 2 - OPT_J.init_sigma ** 2, 0.01))
    base = js._blur_matmul(img, pre)
    gauss, dog, _ = js.build_octave(base, OPT_J)
    mag, ang = js._gradients(gauss[1])
    return base, gauss, dog, js._neighbor_extrema(dog), \
        js._pack_mag_ang(mag, ang)


@pytest.fixture(scope="module")
def jax_runs():
    """sba_tpu's results, computed once: the pyramid stages per image, and
    the features of every image and of every image one ulp up in one
    call of `extract_sift_batch` (batch 8, the program sba_tpu's
    feature_extractor compiles for four such views)."""
    pyr = jax.jit(_jax_pyramid)
    imgs = {name: make() for name, make in IMAGES.items()}
    stack = [imgs[n] for n in IMAGES] + [
        np.nextafter(imgs[n], np.float32(2)) for n in IMAGES]
    stack += [stack[-1]] * (8 - len(stack))
    kp, du, mk = js.extract_sift_batch(np.stack(stack), OPT_J)
    out = {}
    with jax.enable_x64(False):
        for k, name in enumerate(IMAGES):
            p = [np.asarray(a) if not isinstance(a, tuple)
                 else tuple(np.asarray(b) for b in a)
                 for a in pyr(imgs[name])]
            u = k + len(IMAGES)
            out[name] = dict(img=imgs[name], pyr=p,
                             feats=(kp[k], du[k], mk[k]),
                             feats_ulp=(kp[u], du[u], mk[u]))
    return out


@pytest.mark.parametrize("name", list(IMAGES))
def test_pyramid_and_extrema(name, jax_runs):
    r = jax_runs[name]
    img = T(r["img"])
    base_j, gauss_j, dog_j, (mx_j, mn_j), packed_j = r["pyr"]
    pre = np.sqrt(max(OPT_T.sigma0 ** 2 - OPT_T.init_sigma ** 2, 0.01))
    base = ts._blur_matmul(img, pre)
    gauss, dog, nb = ts.build_octave(base, OPT_T)
    assert np.abs(base.numpy() - base_j).max() <= 1e-5
    assert np.abs(gauss.numpy() - gauss_j).max() <= 1e-5
    assert np.abs(dog.numpy() - dog_j).max() <= 1e-5
    assert nb.shape == (H // 2, W // 2)
    # On sba_tpu's own DoG the extremum test is exact.
    mx, mn = ts._neighbor_extrema(T(dog_j))
    assert (mx.numpy() == mx_j).all() and (mn.numpy() == mn_j).all()
    # On the port's DoG it differs only where a centre is within 1e-6 of
    # a neighbour.
    mx, mn = ts._neighbor_extrema(dog)
    d = dog_j
    c = d[1:-1]
    gap = np.full(c.shape, np.inf, np.float32)
    pad = np.pad(d, ((0, 0), (1, 1), (1, 1)), constant_values=np.inf)
    for dl in (0, 1, 2):
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                if (dl, dy, dx) != (1, 1, 1):
                    nbr = pad[dl:dl + c.shape[0], dy:dy + H, dx:dx + W]
                    gap = np.minimum(gap, np.abs(c - nbr))
    near = gap <= 1e-6
    assert ((mx.numpy() == mx_j) | near).all()
    assert ((mn.numpy() == mn_j) | near).all()
    assert mx_j.sum() + mn_j.sum() > 20


@pytest.mark.parametrize("name", list(IMAGES))
def test_packed_gradients(name, jax_runs):
    """bf16 magnitude | bf16 angle, rounded to nearest even, from the
    same level: the same words, except where atan2's last float32 bit
    (which differs between the libraries) sits on a bf16 rounding tie."""
    r = jax_runs[name]
    gauss_j = r["pyr"][1]
    packed_j = r["pyr"][4].view(np.int32)
    mag, ang = ts._gradients(T(gauss_j[1]))
    packed = ts._pack_mag_ang(mag, ang).numpy()
    diff = packed != packed_j
    assert (packed[diff] & 0xFFFF == packed_j[diff] & 0xFFFF).all()
    hi = (packed[diff] >> 16) & 0xFFFF
    hi_j = (packed_j[diff] >> 16) & 0xFFFF
    assert (np.abs(hi.astype(int) - hi_j.astype(int)) == 1).all()
    assert diff.mean() <= 1e-4
    m, a = ts._unpack(T(packed))
    assert (m.numpy() == mag.to(torch.bfloat16).float().numpy()).all()
    assert (a.numpy() == ang.to(torch.bfloat16).float().numpy()).all()


@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
def test_orientation_and_descriptor_stages(sampling):
    """Histograms, peaks and descriptors of the same candidates on the
    same packed buffer, with either gradient sampling."""
    rng = np.random.default_rng(4)
    Hp, Wp = 60, 80
    mag = rng.random((2, Hp, Wp)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (2, Hp, Wp)).astype(np.float32)
    K = 40
    kx = rng.uniform(8, Wp - 8, K).astype(np.float32)
    ky = rng.uniform(8, Hp - 8, K).astype(np.float32)
    sig = rng.uniform(1.6, 3.0, K).astype(np.float32)
    base = rng.integers(0, 2, K).astype(np.int32) * Hp * Wp
    kh = np.full(K, Hp, np.int32)
    kw = np.full(K, Wp, np.int32)
    ori = rng.uniform(0, 2 * np.pi, K).astype(np.float32)

    jopt = js.SiftExtractionOptions(grad_sampling=sampling)
    topt = ts.SiftExtractionOptions(grad_sampling=sampling)

    @jax.jit
    def stages(m, a):
        flat = js._pack_mag_ang(m, a).reshape(-1)
        h = js._orientation_histograms(flat, kx, ky, sig, base, kh, kw,
                                       sampling)
        d = js._descriptors(flat, kx, ky, sig, ori, base, kh, kw, jopt)
        n = {k: js._normalize_descriptors(d, k) for k in ("L1_ROOT", "L2")}
        return (flat, h, js._histogram_peaks(h, 2), d, n,
                js.descriptors_to_uint8(n["L1_ROOT"]))

    with jax.enable_x64(False):
        out = jax.tree.map(np.asarray, stages(mag, ang))
    flat_j, hj, (oj, vj), dj, nj, uj = out
    flat = T(flat_j.view(np.int32))
    args = [T(a) for a in (kx, ky, sig, base, kh, kw)]
    ht = ts._orientation_histograms(flat, *args, sampling).numpy()
    assert np.abs(ht - hj).max() <= 1e-5 * max(1.0, np.abs(hj).max())
    ot, vt = ts._histogram_peaks(T(hj), 2)
    assert (vt.numpy() == np.asarray(vj)).all()
    v = np.asarray(vj)
    assert np.abs(ot.numpy()[v] - np.asarray(oj)[v]).max() <= 1e-5
    dt = ts._descriptors(flat, T(kx), T(ky), T(sig), T(ori), T(base),
                         T(kh), T(kw), topt).numpy()
    assert np.abs(dt - dj).max() <= 1e-5 * max(1.0, np.abs(dj).max())
    for n in ("L1_ROOT", "L2"):
        nt = ts._normalize_descriptors(T(dj), n).numpy()
        assert np.abs(nt - nj[n]).max() <= 1e-6
    ut = ts.descriptors_to_uint8(T(nj["L1_ROOT"])).numpy()
    assert (ut == uj).all()


def keypoint_rows(ft, fj, tol=1e-3):
    """Share of the common valid rows (ft, fj: keypoints, _, mask) whose
    x, y, scale (px) and orientation (rad) agree within tol, the worst
    row, and the common rows."""
    m = ft[2] & fj[2]
    d = np.abs(ft[0][m] - fj[0][m])
    d[:, 3] = np.minimum(d[:, 3], 2 * np.pi - d[:, 3])
    worst = d.max(axis=1)
    return (worst <= tol).mean(), worst.max(), m


@pytest.mark.parametrize("name", list(IMAGES))
def test_extract_sift_final(name, jax_runs):
    r = jax_runs[name]
    ft = [a.numpy() for a in ts.extract_sift(r["img"], OPT_T,
                                             device="cpu")[:4]]
    kj, uj, mj = r["feats"]
    fj = (kj, None, mj)
    assert (ft[2] == mj).all() and mj.sum() >= 4
    share, worst, m = keypoint_rows(ft, fj)
    ku, _, mu = r["feats_ulp"]
    self_share, self_worst, _ = keypoint_rows((ku, None, mu), fj)
    print(f"{name}: port {share:.4f} of rows at 1e-3 (worst {worst:.2e}); "
          f"sba_tpu one ulp off {self_share:.4f} (worst {self_worst:.2e})")
    assert share >= 0.98 and worst <= 5e-3
    ut = ts.descriptors_to_uint8(T(ft[1])).numpy()[m]
    assert (np.abs(ut.astype(int) - uj[m].astype(int)) <= 1).mean() >= 0.99
    np.testing.assert_array_equal(ft[3] > 0, mj)
    kb, db, mb = ts.extract_sift_batch(np.stack([r["img"]] * 2), OPT_T,
                                       device="cpu")
    assert (kb[0] == kb[1]).all() and (mb[0] == ft[2]).all()
    assert (db[0] == ts.descriptors_to_uint8(T(ft[1])).numpy()).all()


def test_unported_options_raise():
    """The options sba_tpu has beyond the defaults all compute in the
    port now (each used to raise NotImplementedError): finite features of
    the budget's shape, and `build_octave(impl="conv")` gives an octave."""
    img = blob_image(64, 64, [(20, 20), (40, 44)], [3.0, 4.0])
    for kw in (dict(first_octave=-1), dict(estimate_affine_shape=True),
               dict(domain_size_pooling=True)):
        ft = ts.extract_sift(img, ts.SiftExtractionOptions(
            max_num_features=32, **kw), device="cpu")
        assert ft.keypoints.shape == (32, 4)
        assert torch.isfinite(ft.descriptors).all()
        assert (ft.affine is not None) == bool(
            kw.get("estimate_affine_shape"))
    gauss, dog, nb = ts.build_octave(T(img), OPT_T, impl="conv")
    assert gauss.shape == (6, 64, 64) and nb.shape == (32, 32)


# ---------------------------------------------------------------------------
# The options beyond the defaults: first_octave -1, the affine shape,
# domain-size pooling and the conv octave.
# ---------------------------------------------------------------------------

VARIANTS = {"first_octave": dict(first_octave=-1),
            "affine": dict(estimate_affine_shape=True),
            "dsp": dict(domain_size_pooling=True)}


@pytest.fixture(scope="module")
def jax_variants():
    """sba_tpu's features of the textured view and of the view one ulp up,
    one `extract_sift_batch` call per option set."""
    img = IMAGES["textured"]()
    stack = np.stack([img, np.nextafter(img, np.float32(2))])
    out = {}
    for name, kw in VARIANTS.items():
        out[name] = js.extract_sift_batch(
            stack, js.SiftExtractionOptions(max_num_features=256, **kw))
    return img, out


def affine_rows(k):
    """[K, 6] affine keypoints -> ([K, 4] (x, y, scale, orientation), the
    shapes S [K, 2, 2]): A = scale * S @ R with det S = 1 and S symmetric
    positive definite, so scale = sqrt(det A) and R is A's polar factor."""
    A = k[:, 2:].reshape(-1, 2, 2).astype(np.float64)
    sc = np.sqrt(np.abs(np.linalg.det(A)))
    M = A / sc[:, None, None]
    u, _, vt = np.linalg.svd(M)
    R = u @ vt
    ori = np.mod(np.arctan2(R[:, 1, 0], R[:, 0, 0]), 2 * np.pi)
    return (np.stack([k[:, 0], k[:, 1], sc, ori], 1),
            M @ np.transpose(R, (0, 2, 1)))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_option_variants_final(name, jax_variants):
    """The port's features against sba_tpu's. first_octave -1 and DSP are
    held to the row rule of `test_extract_sift_final` (98% of rows within
    1e-3 px and rad, all within 5e-3; u8 descriptors within 1 in 99%).
    The affine shape comes out of six Baumberg iterations that amplify a
    float32 rounding: sba_tpu against itself, one ulp off, keeps only
    ~95% of (x, y, scale, orientation) rows within 1e-3 (worst ~0.025
    rad) and moves S by up to ~4e-3. So there x, y and scale (which do
    not depend on S) keep the row rule's 5e-3, while orientation and S are
    held to that spread: 90% of rows within 1e-3, all within 0.05, S
    within 1e-2 everywhere and 1e-5 in the median row; descriptors within
    1 in 98%."""
    img, out = jax_variants
    kj, uj, mj = out[name]
    kt, ut, mt = ts.extract_sift_batch(
        img[None], ts.SiftExtractionOptions(max_num_features=256,
                                            **VARIANTS[name]), device="cpu")
    kt, ut, mt = kt[0], ut[0], mt[0]
    assert (mt == mj[0]).all() and mt.sum() >= 50
    m = mt
    desc_share = (np.abs(ut[m].astype(int) - uj[0][m].astype(int))
                  <= 1).mean()
    if name != "affine":
        share, worst, _ = keypoint_rows((kt, None, mt), (kj[0], None, mj[0]))
        assert share >= 0.98 and worst <= 5e-3
        assert desc_share >= 0.99
        return
    assert kt.shape == (256, 6)
    rt, St = affine_rows(kt[m])
    rj, Sj = affine_rows(kj[0][m])
    ru, Su = affine_rows(kj[1][m & mj[1]])
    d = np.abs(rt - rj)
    d[:, 3] = np.minimum(d[:, 3], 2 * np.pi - d[:, 3])
    assert d[:, :3].max() <= 5e-3
    worst = d.max(1)
    dS = np.abs(St - Sj).max((1, 2))
    du = np.abs(ru - rj[:len(ru)])
    print(f"affine: {(worst <= 1e-3).mean():.4f} of rows at 1e-3 (worst "
          f"{worst.max():.2e}), S worst {dS.max():.2e}; sba_tpu one ulp "
          f"off: worst row {du[:, :3].max():.2e} (x, y, scale)")
    assert (worst <= 1e-3).mean() >= 0.9 and worst.max() <= 0.05
    assert dS.max() <= 1e-2 and np.median(dS) <= 1e-5
    assert np.abs(np.linalg.det(St) - 1).max() <= 1e-3
    assert desc_share >= 0.98


def test_affine_and_dsp_stages():
    """The Baumberg iteration, the shaped orientation windows, the shaped
    and the pooled descriptors on the same packed buffer and keypoints as
    sba_tpu's stages (both sampling modes for the descriptors), at 1e-5;
    and sba_tpu's quirk: with DSP on, the descriptors ignore the shape."""
    rng = np.random.default_rng(5)
    Hp, Wp = 60, 80
    mag = rng.random((2, Hp, Wp)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (2, Hp, Wp)).astype(np.float32)
    K = 24
    kx = rng.uniform(12, Wp - 12, K).astype(np.float32)
    ky = rng.uniform(12, Hp - 12, K).astype(np.float32)
    sig = rng.uniform(1.6, 2.5, K).astype(np.float32)
    base = rng.integers(0, 2, K).astype(np.int32) * Hp * Wp
    kh = np.full(K, Hp, np.int32)
    kw = np.full(K, Wp, np.int32)
    ori = rng.uniform(0, 2 * np.pi, K).astype(np.float32)
    jdsp = js.SiftExtractionOptions(domain_size_pooling=True)

    @jax.jit
    def stages(m, a):
        flat = js._pack_mag_ang(m, a).reshape(-1)
        S, an = js._affine_adapt(flat, kx, ky, sig, base, kh, kw, 6,
                                 "nearest")
        h = js._orientation_histograms(flat, kx, ky, sig, base, kh, kw,
                                       "nearest", shape=S)
        d = js._descriptors(flat, kx, ky, sig, ori, base, kh, kw, None,
                            shape=S)
        p = js._descriptors(flat, kx, ky, sig, ori, base, kh, kw, jdsp,
                            shape=S)
        return flat, S, an, h, d, p

    with jax.enable_x64(False):
        flat_j, Sj, anj, hj, dj, pj = jax.tree.map(np.asarray,
                                                   stages(mag, ang))
    flat = T(flat_j.view(np.int32))
    args = [T(a) for a in (kx, ky, sig, base, kh, kw)]
    St, ant = ts._affine_adapt(flat, *args, 6, "nearest")
    assert np.abs(St.numpy() - Sj).max() <= 1e-5
    assert np.abs(ant.numpy() - anj).max() <= 1e-4 * np.abs(anj).max()
    ht = ts._orientation_histograms(flat, *args, "nearest",
                                    shape=T(Sj)).numpy()
    assert np.abs(ht - hj).max() <= 1e-5 * max(1.0, np.abs(hj).max())
    kargs = [T(kx), T(ky), T(sig), T(ori), T(base), T(kh), T(kw)]
    dt = ts._descriptors(flat, *kargs, None, shape=T(Sj)).numpy()
    assert np.abs(dt - dj).max() <= 1e-5 * max(1.0, np.abs(dj).max())
    tdsp = ts.SiftExtractionOptions(domain_size_pooling=True)
    pt = ts._descriptors(flat, *kargs, tdsp, shape=T(Sj)).numpy()
    assert np.abs(pt - pj).max() <= 1e-5 * max(1.0, np.abs(pj).max())
    assert (ts._descriptors(flat, *kargs, tdsp).numpy() == pt).all()


def test_conv_octave_and_upsample():
    """`build_octave(impl="conv")` (sba_tpu's incremental chain) and the
    2x upsample of first_octave -1, against sba_tpu at 1e-5."""
    img = IMAGES["blob"]()
    with jax.enable_x64(False):
        gj, dj, nj = map(np.asarray, jax.jit(
            lambda x: js.build_octave(x, OPT_J, impl="conv"))(img))
        uj = np.asarray(jax.jit(js._upsample2)(img))
    gt, dt, nt = ts.build_octave(T(img), OPT_T, impl="conv")
    assert np.abs(gt.numpy() - gj).max() <= 1e-5
    assert np.abs(dt.numpy() - dj).max() <= 1e-5
    assert np.abs(nt.numpy() - nj).max() <= 1e-5
    ut = ts._upsample2(T(img)).numpy()
    assert ut.shape == (2 * H, 2 * W)
    assert np.abs(ut - uj).max() <= 1e-6
    gb = ts.build_octave(T(np.stack([img, img[::-1]])), OPT_T,
                         impl="conv")[0]
    assert np.abs((gb[0] - gt).numpy()).max() <= 1e-6
