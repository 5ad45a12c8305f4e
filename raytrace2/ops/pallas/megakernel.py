"""Path-regeneration MEGAKERNEL: the whole sample and bounce loop in one
Pallas kernel, compiled through Triton for the GPU.

Why a kernel: the XLA bounce loop (ops/integrator.trace_rays) writes the
whole ray state to device memory and reads it back between its fused
sub-steps on every bounce — XLA does not fuse across ``while_loop``
iterations. Here each lane keeps its path state in registers for the whole
dispatch, so the only device-memory traffic is the scene table (small
enough to stay in L1/L2) and one radiance store per pixel.

Structure (SIMT, one lane per pixel):

* Each program owns ``BLOCK`` consecutive pixel slots (a power of two).
* Every lane loops over bounces; when its path ends it regenerates the
  camera ray of its next progressive sample in-lane (stratified jitter,
  defocus disk, shutter time), until all its samples are done. The radiance
  accumulated over a lane's samples is the progressive-accumulator
  contribution of the batch.
* The scene lives in ONE packed f32 table in global memory (``pack_table``):
  a camera/control header, then each primitive family's records row-major.
  The closest-hit sweep loops over records reading broadcast scalars; the
  material/texture resolve gathers per lane.
* RNG: the murmur3 counter-hash streams of ``rng.murmur_uniforms`` — camera
  counters ``CAMERA_CTR_BASE + k``, ``3 + n_media`` draws per bounce — so the
  XLA path with ``features["rng_impl"] = "murmur"`` traces the same paths
  and is the plain reference for this kernel.

Scope: spheres, quads, axis-aligned boxes (slab tests), constant media, all
six material types, solid and checker textures. Scenes with noise
textures, ellipsoids or more than ``MAX_RECORDS`` primitive records render
on the XLA path (``supports``). Reference semantics: src/cpu_raytrace/
Sphere.cpp:7-26, Quad.cpp:19-43, ConstantMedium.cpp:14-58, Material.cpp,
Texture.cpp.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from raytrace2 import defs
from raytrace2.ops import camera as camera_ops
from raytrace2.ops import rng

BIG = 3.0e38
# Pixel slots (lanes) per program and warps per program: 64 lanes on 2 warps
# measured fastest on an H100 for Cornell 600², depth 50 (PERF.md).
BLOCK = 64
NUM_WARPS = 2
# Families of at most this many records are unrolled at trace time; longer
# ones sweep in a loop (unrolled measured ~2.5% faster on Cornell's 18 quads).
UNROLL = 32
# Primitive records (spheres + quads + boxes + media) above which a scene
# renders on the XLA path: the kernel sweeps every record for every ray, so
# its cost grows linearly with records. 4096 is the largest size measured:
# a noise-free book 2 grown to 4096 records ran 114x the XLA path with the
# sphere BVH on an H100 (PERF.md); beyond it neither route was timed.
MAX_RECORDS = 4096

# Packed-table header: the camera frame and batch parameters.
#   0:3 pixel00, 3:6 pixel_delta_u, 6:9 pixel_delta_v, 9:12 center,
#   12:15 defocus_disk_u, 15:18 defocus_disk_v, 18 defocus_angle,
#   19 width, 20 n_pixels, 21 first sample, 22 n_samples, 23 sqrt_spp,
#   24 first pixel slot of this call, 25:28 background.
HEADER_LEN = 28
SPH_FIELDS = ("c0x", "c0y", "c0z", "dpx", "dpy", "dpz", "rad", "mat")
QUAD_FIELDS = ("nx", "ny", "nz", "d", "aax", "aay", "aaz", "abx", "aby",
               "abz", "qaa", "qab", "mat")
BOX_FIELDS = ("x0", "y0", "z0", "x1", "y1", "z1", "mat")
MED_FIELDS = ("btype", "p0x", "p0y", "p0z", "p1x", "p1y", "p1z",
              "dspx", "dspy", "dspz",
              "i00", "i01", "i02", "i03", "i10", "i11", "i12", "i13",
              "i20", "i21", "i22", "i23", "nid", "mat")
MAT_FIELDS = ("mtype", "alr", "alg", "alb", "param", "tex")
TEX_FIELDS = ("ttype", "alr", "alg", "alb", "inv_scale", "even", "odd")
_FAMILIES = (("sph", SPH_FIELDS), ("quad", QUAD_FIELDS), ("box", BOX_FIELDS),
             ("med", MED_FIELDS), ("mat", MAT_FIELDS), ("tex", TEX_FIELDS))


def n_records(sizes) -> int:
    """Primitive records the closest-hit sweep visits per ray."""
    n_sph, n_quad, _, _, n_med, n_box = sizes
    return n_sph + n_quad + n_box + n_med


def supports(features) -> bool:
    """Whether the kernel can render a scene with these feature gates."""
    sizes = features.get("mega_sizes")
    return (sizes is not None and not features.get("has_noise", False)
            and n_records(sizes) <= MAX_RECORDS)


def table_offsets(sizes):
    """Static start offset of each family in the packed table, and its
    total length. ``sizes`` = (spheres, plain quads, materials, textures,
    media, boxes) as in ``FlatScene.features()["mega_sizes"]``."""
    n_sph, n_quad, n_mat, n_tex, n_med, n_box = sizes
    counts = dict(sph=n_sph, quad=n_quad, box=n_box, med=n_med, mat=n_mat,
                  tex=n_tex)
    offsets, pos = {}, HEADER_LEN
    for name, fields in _FAMILIES:
        offsets[name] = pos
        pos += counts[name] * len(fields)
    return offsets, pos


def pack_table(scene, sizes, header):
    """The packed f32 table: ``header`` (HEADER_LEN entries) followed by
    every family's ACTIVE records, row-major. The loader packs active
    records as a prefix, so static slices select them."""
    n_sph, n_quad, n_mat, n_tex, n_med, n_box = sizes

    def rows(cols, n):
        return jnp.stack([jnp.asarray(c, jnp.float32)[:n] for c in cols],
                         axis=-1).reshape(-1)

    sp, q, bx, md = scene.spheres, scene.quads, scene.boxes, scene.media
    a_alpha = jnp.cross(q.v, q.w)
    a_beta = jnp.cross(q.w, q.u)
    inv = md.inv_model
    t = scene.textures
    parts = [jnp.asarray(header, jnp.float32)]
    parts.append(rows([sp.center0[:, 0], sp.center0[:, 1], sp.center0[:, 2],
                       sp.displacement[:, 0], sp.displacement[:, 1],
                       sp.displacement[:, 2], sp.radius, sp.material], n_sph))
    parts.append(rows([q.normal[:, 0], q.normal[:, 1], q.normal[:, 2], q.d,
                       a_alpha[:, 0], a_alpha[:, 1], a_alpha[:, 2],
                       a_beta[:, 0], a_beta[:, 1], a_beta[:, 2],
                       jnp.sum(q.q * a_alpha, -1), jnp.sum(q.q * a_beta, -1),
                       q.material], n_quad))
    parts.append(rows([bx.bmin[:, 0], bx.bmin[:, 1], bx.bmin[:, 2],
                       bx.bmax[:, 0], bx.bmax[:, 1], bx.bmax[:, 2],
                       bx.material], n_box))
    parts.append(rows([md.btype, md.p0[:, 0], md.p0[:, 1], md.p0[:, 2],
                       md.p1[:, 0], md.p1[:, 1], md.p1[:, 2],
                       md.displacement[:, 0], md.displacement[:, 1],
                       md.displacement[:, 2]]
                      + [inv[:, i, j] for i in range(3) for j in range(4)]
                      + [md.neg_inv_density, md.material], n_med))
    m = scene.materials
    parts.append(rows([m.mtype, m.albedo[:, 0], m.albedo[:, 1],
                       m.albedo[:, 2], m.param, m.tex], n_mat))
    parts.append(rows([t.ttype, t.albedo[:, 0], t.albedo[:, 1],
                       t.albedo[:, 2], t.inv_scale, t.even, t.odd], n_tex))
    return jnp.concatenate(parts)


def _mix(x):
    """murmur3 fmix32 — the same mixer as ``rng.murmur_mix``."""
    x = x ^ (x >> jnp.uint32(16))
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> jnp.uint32(13))
    x = x * jnp.uint32(0xC2B2AE35)
    x = x ^ (x >> jnp.uint32(16))
    return x


def _uniform(key, ctr):
    """U[0,1) draw ``ctr`` of the stream ``key`` (``rng.murmur_uniforms_at``
    construction, top 24 bits)."""
    c = jnp.asarray(ctr).astype(jnp.uint32)
    bits = _mix(key ^ _mix(c * jnp.uint32(0x9E3779B9) + jnp.uint32(1)))
    return (bits >> jnp.uint32(8)).astype(jnp.int32).astype(jnp.float32) * (
        1.0 / (1 << 24))


def sample_key(seed, pixel, sample):
    """Stream key of one (pixel, sample): mix(pixel·G ^ mix(seed·1000003 +
    sample)) in uint32 arithmetic — the key ``rng.murmur_uniforms`` derives
    from ``mega_seed = seed·1000003 + sample``. (Deriving it in f32 would
    lose integer precision above 2^24 and collapse samples for seed >= 17.)"""
    seed_u = jnp.asarray(seed).astype(jnp.int32).astype(jnp.uint32)
    pix_u = jnp.asarray(pixel).astype(jnp.uint32)
    s_u = jnp.asarray(sample).astype(jnp.int32).astype(jnp.uint32)
    return _mix(pix_u * jnp.uint32(0x9E3779B9)
                ^ _mix(seed_u * jnp.uint32(1000003) + s_u))


def _safe_inv(c):
    """1/c with the sign-preserving epsilon clamp used by all slab tests."""
    return 1.0 / jnp.where(jnp.abs(c) < 1e-12,
                           jnp.where(c < 0, -1e-12, 1e-12), c)


def _closest_hit(T, off, sizes, key, tm, bn, o, d, skip):
    """Sweep every record of every family; returns the winning record
    (best_t, fam, mat, p0, p1, p2, aux, code, idx): fam 0 sphere /
    1 quad|box / 2 medium / -1 miss; p0..p2 the sphere center or the
    surface normal (outward for boxes); aux the sphere radius; code the
    record's family (0 sphere / 1 quad / 2 box / 3 medium) and idx its
    index. ``skip`` = (code, idx) of the surface the ray leaves, which it
    cannot hit (see intersect.closest_hit)."""
    n_sph, n_quad, _, _, n_med, n_box = sizes
    ox, oy, oz = o
    dx, dy, dz = d
    t_min = jnp.float32(float(defs.T_MIN))
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a

    skip_code, skip_idx = skip

    def upd(rec, closer, vals, code, p):
        closer = closer & ~((skip_code == code) & (skip_idx == p))
        vals = vals + (float(code), p)
        return tuple(jnp.where(closer, v, r) for v, r in zip(vals, rec))

    def sph_body(p, rec):
        best_t = rec[0]
        base = off["sph"] + p * len(SPH_FIELDS)
        cx = T(base + 0) + tm * T(base + 3)
        cy = T(base + 1) + tm * T(base + 4)
        cz = T(base + 2) + tm * T(base + 5)
        ocx, ocy, ocz = cx - ox, cy - oy, cz - oz
        h = dx * ocx + dy * ocy + dz * ocz
        rad = T(base + 6)
        cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
        disc = h * h - a * cc
        has = disc >= 0.0
        sq = jnp.sqrt(jnp.where(has, disc, 0.0))
        root0 = (h - sq) * inv_a
        root1 = (h + sq) * inv_a
        ok0 = (root0 > t_min) & (root0 < best_t)
        ok1 = (root1 > t_min) & (root1 < best_t)
        root = jnp.where(ok0, root0, root1)
        return upd(rec, has & (ok0 | ok1),
                   (root, 0.0, T(base + 7), cx, cy, cz, rad), 0, p)

    quad_eps = jnp.float32(float(defs.QUAD_EPS))

    def quad_body(p, rec):
        best_t = rec[0]
        base = off["quad"] + p * len(QUAD_FIELDS)
        nx, ny, nz = T(base + 0), T(base + 1), T(base + 2)
        nd = dx * nx + dy * ny + dz * nz
        no = ox * nx + oy * ny + oz * nz
        not_par = jnp.abs(nd) >= quad_eps
        t = (T(base + 3) - no) / jnp.where(not_par, nd, 1.0)
        aax, aay, aaz = T(base + 4), T(base + 5), T(base + 6)
        abx, aby, abz = T(base + 7), T(base + 8), T(base + 9)
        alpha = (ox * aax + oy * aay + oz * aaz
                 + t * (dx * aax + dy * aay + dz * aaz) - T(base + 10))
        beta = (ox * abx + oy * aby + oz * abz
                + t * (dx * abx + dy * aby + dz * abz) - T(base + 11))
        closer = (not_par & (t >= t_min) & (t <= best_t)
                  & (alpha >= 0.0) & (alpha <= 1.0)
                  & (beta >= 0.0) & (beta <= 1.0))
        return upd(rec, closer, (t, 1.0, T(base + 12), nx, ny, nz, rec[6]),
                   1, p)

    # Axis-aligned boxes: slab test — entry hit at t0 with the entering
    # face's outward normal, exit hit at t1 for rays starting inside; the
    # same surfaces as the loader's 6-quad expansion on the XLA path.
    inv_dx, inv_dy, inv_dz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)

    def box_body(b, rec):
        best_t = rec[0]
        base = off["box"] + b * len(BOX_FIELDS)
        tax = (T(base + 0) - ox) * inv_dx
        tbx = (T(base + 3) - ox) * inv_dx
        tay = (T(base + 1) - oy) * inv_dy
        tby = (T(base + 4) - oy) * inv_dy
        taz = (T(base + 2) - oz) * inv_dz
        tbz = (T(base + 5) - oz) * inv_dz
        lox, hix = jnp.minimum(tax, tbx), jnp.maximum(tax, tbx)
        loy, hiy = jnp.minimum(tay, tby), jnp.maximum(tay, tby)
        loz, hiz = jnp.minimum(taz, tbz), jnp.maximum(taz, tbz)
        t0 = jnp.maximum(lox, jnp.maximum(loy, loz))
        t1 = jnp.minimum(hix, jnp.minimum(hiy, hiz))
        enter = t0 >= t_min
        t = jnp.where(enter, t0, t1)
        closer = (t1 > t0) & (t > t_min) & (t < best_t) & (t1 > t_min)
        ax_x = (enter & (t0 == lox)) | (~enter & (t1 == hix))
        ax_y = ((enter & (t0 == loy)) | (~enter & (t1 == hiy))) & ~ax_x
        ax_z = ~ax_x & ~ax_y
        sgn = jnp.where(enter, -1.0, 1.0)
        nxb = jnp.where(ax_x, sgn * jnp.sign(dx), 0.0)
        nyb = jnp.where(ax_y, sgn * jnp.sign(dy), 0.0)
        nzb = jnp.where(ax_z, sgn * jnp.sign(dz), 0.0)
        return upd(rec, closer, (t, 1.0, T(base + 6), nxb, nyb, nzb, rec[6]),
                   2, b)

    draws_pb = 3 + n_med
    d_len = jnp.sqrt(jnp.maximum(a, 1e-24))

    def med_body(m, rec):
        # Analytic boundary entry/exit in model space, then an exponential
        # free path (ConstantMedium.cpp:14-58; ops/intersect._media_ts).
        best_t = rec[0]
        base = off["med"] + m * len(MED_FIELDS)

        def row(i):
            return T(base + 10 + 4 * i), T(base + 11 + 4 * i), \
                T(base + 12 + 4 * i), T(base + 13 + 4 * i)

        (a00, a01, a02, b0), (a10, a11, a12, b1), (a20, a21, a22, b2) = (
            row(0), row(1), row(2))
        omx = a00 * ox + a01 * oy + a02 * oz + b0
        omy = a10 * ox + a11 * oy + a12 * oz + b1
        omz = a20 * ox + a21 * oy + a22 * oz + b2
        dmx = a00 * dx + a01 * dy + a02 * dz
        dmy = a10 * dx + a11 * dy + a12 * dz
        dmz = a20 * dx + a21 * dy + a22 * dz
        dm_len = jnp.sqrt(jnp.maximum(dmx * dmx + dmy * dmy + dmz * dmz,
                                      1e-24))
        dmx, dmy, dmz = dmx / dm_len, dmy / dm_len, dmz / dm_len
        p0x, p0y, p0z = T(base + 1), T(base + 2), T(base + 3)
        p1x, p1y, p1z = T(base + 4), T(base + 5), T(base + 6)
        # Sphere boundary (moving center, radius in p1x).
        ocx = p0x + tm * T(base + 7) - omx
        ocy = p0y + tm * T(base + 8) - omy
        ocz = p0z + tm * T(base + 9) - omz
        h = dmx * ocx + dmy * ocy + dmz * ocz
        disc = h * h - (ocx * ocx + ocy * ocy + ocz * ocz - p1x * p1x)
        s_valid = disc > 0.0
        sq = jnp.sqrt(jnp.where(s_valid, disc, 0.0))
        s_t0, s_t1 = h - sq, h + sq

        def slab(dmc, omc, lo, hi):
            inv = _safe_inv(dmc)
            ta, tb = (lo - omc) * inv, (hi - omc) * inv
            return jnp.minimum(ta, tb), jnp.maximum(ta, tb)

        bx0, bx1 = slab(dmx, omx, p0x, p1x)
        by0, by1 = slab(dmy, omy, p0y, p1y)
        bz0, bz1 = slab(dmz, omz, p0z, p1z)
        b_t0 = jnp.maximum(bx0, jnp.maximum(by0, bz0))
        b_t1 = jnp.minimum(bx1, jnp.minimum(by1, bz1))
        is_box = T(base + 0) == float(defs.MEDIUM_BOX)
        t0_ = jnp.where(is_box, b_t0, s_t0)
        t1_ = jnp.where(is_box, b_t1, s_t1)
        v = (is_box & (b_t0 < b_t1)) | (~is_box & s_valid)
        v = v & (t1_ > t0_ + jnp.float32(float(defs.MEDIUM_EPS)))
        scale = dm_len / d_len                  # model units per world t
        e0 = jnp.maximum(jnp.maximum(t0_, t_min * scale), 0.0)
        e1 = jnp.minimum(t1_, best_t * scale)
        u_m = _uniform(key, bn.astype(jnp.int32) * draws_pb + 3 + m)
        hit_dist = T(base + 22) * jnp.log(jnp.maximum(u_m, 1e-12))
        v = v & (e0 < e1) & (hit_dist <= (e1 - e0))
        return upd(rec, v, ((e0 + hit_dist) / scale, 2.0, T(base + 23),
                            1.0, 0.0, 0.0, rec[6]), 3, m)

    shape = ox.shape
    rec = (jnp.full(shape, BIG, jnp.float32),
           jnp.full(shape, -1.0, jnp.float32)) + tuple(
        jnp.full(shape, v, jnp.float32)
        for v in (0.0, 0.0, 0.0, 0.0, 1.0, -1.0, 0.0))
    for n, body in ((n_sph, sph_body), (n_quad, quad_body),
                    (n_box, box_body), (n_med, med_body)):
        if n <= UNROLL:
            for p in range(n):
                rec = body(p, rec)
        else:
            rec = jax.lax.fori_loop(0, n, body, rec)
    return rec


def _shade(T, G, off, key, bn, alive, o, d, tp, rad, rec, bg, *,
           has_checker, n_med, max_depth):
    """Hit record → emission, attenuation and the scattered ray; returns
    the lane's next (bn, alive, o, d, throughput, radiance, skip).
    Material.cpp / Texture.cpp semantics, as ops/materials.shade."""
    ox, oy, oz = o
    dx, dy, dz = d
    tpr, tpg, tpb = tp
    rr, rg, rb = rad
    best_t, fam, matf, p0, p1, p2, aux, code, idx = rec
    valid = fam >= 0.0
    is_sph = fam == 0.0
    is_med = fam == 2.0
    px, py, pz = ox + best_t * dx, oy + best_t * dy, oz + best_t * dz
    rad_safe = jnp.where(aux != 0.0, aux, 1.0)
    onx = jnp.where(is_sph, (px - p0) / rad_safe, p0)
    ony = jnp.where(is_sph, (py - p1) / rad_safe, p1)
    onz = jnp.where(is_sph, (pz - p2) / rad_safe, p2)
    front_geom = (dx * onx + dy * ony + dz * onz) < 0.0
    # Medium scatter: arbitrary fixed normal, always front-face
    # (ConstantMedium.cpp:50-55).
    front = front_geom | is_med
    sgn = jnp.where(is_med | front_geom, 1.0, -1.0)
    nx_, ny_, nz_ = sgn * onx, sgn * ony, sgn * onz

    mbase = off["mat"] + matf.astype(jnp.int32) * len(MAT_FIELDS)
    mtype, alr, alg, alb, mparam, mtex = (G(mbase + i) for i in range(6))

    def tex_row(leaf):
        tbase = off["tex"] + leaf.astype(jnp.int32) * len(TEX_FIELDS)
        return tuple(G(tbase + i) for i in range(len(TEX_FIELDS)))

    leaf = mtex
    ttype, t_alr, t_alg, t_alb, t_inv, t_even, t_odd = tex_row(leaf)
    # ``has_checker`` is the scene's checker nesting depth: one parity and
    # child re-resolve per level (Texture.cpp:7-11).
    for _ in range(int(has_checker)):
        fx = jnp.floor(t_inv * px)
        fy = jnp.floor(t_inv * py)
        fz = jnp.floor(t_inv * pz)
        parity = fx + fy + fz - 2.0 * jnp.floor((fx + fy + fz) * 0.5)
        child = jnp.where(parity == 0.0, t_even, t_odd)
        leaf = jnp.where(ttype == float(defs.TEX_CHECKER), child, leaf)
        ttype, t_alr, t_alg, t_alb, t_inv, t_even, t_odd = tex_row(leaf)

    bctr = bn.astype(jnp.int32) * (3 + n_med)
    u1 = _uniform(key, bctr)
    u2 = _uniform(key, bctr + 1)
    u3 = _uniform(key, bctr + 2)
    z = 1.0 - 2.0 * u1
    phi = jnp.float32(2.0 * 3.14159265358979) * u2
    rxy = jnp.sqrt(jnp.maximum(1.0 - z * z, 1e-12))
    uvx, uvy, uvz = rxy * jnp.cos(phi), rxy * jnp.sin(phi), z

    is_lamb = ((mtype == float(defs.MAT_LAMBERTIAN))
               | (mtype == float(defs.MAT_TEXTURE)))
    is_metal = mtype == float(defs.MAT_METAL)
    is_diel = mtype == float(defs.MAT_DIELECTRIC)
    is_iso = mtype == float(defs.MAT_ISOTROPIC)
    is_light = mtype == float(defs.MAT_DIFFUSE_LIGHT)
    uses_tex = (mtype == float(defs.MAT_TEXTURE)) | is_iso

    # Lambertian: normal + unit vector, degenerate -> normal.
    ldx, ldy, ldz = nx_ + uvx, ny_ + uvy, nz_ + uvz
    eps = jnp.float32(float(defs.NEAR_ZERO_EPS))
    degen = (jnp.abs(ldx) < eps) & (jnp.abs(ldy) < eps) & (jnp.abs(ldz) < eps)
    ldx = jnp.where(degen, nx_, ldx)
    ldy = jnp.where(degen, ny_, ldy)
    ldz = jnp.where(degen, nz_, ldz)
    # Metal: normalized reflection + fuzz · unit vector.
    dn = dx * nx_ + dy * ny_ + dz * nz_
    rfx, rfy, rfz = dx - 2.0 * dn * nx_, dy - 2.0 * dn * ny_, dz - 2.0 * dn * nz_
    rlen = jnp.sqrt(jnp.maximum(rfx * rfx + rfy * rfy + rfz * rfz, 1e-24))
    mdx = rfx / rlen + mparam * uvx
    mdy = rfy / rlen + mparam * uvy
    mdz = rfz / rlen + mparam * uvz
    # Dielectric: Schlick-weighted reflect/refract.
    param_safe = jnp.where(mparam > 0.0, mparam, 1.0)
    ri = jnp.where(front, 1.0 / param_safe, param_safe)
    dlen = jnp.sqrt(jnp.maximum(dx * dx + dy * dy + dz * dz, 1e-24))
    udx, udy, udz = dx / dlen, dy / dlen, dz / dlen
    cos_t = jnp.minimum(-(udx * nx_ + udy * ny_ + udz * nz_), 1.0)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 1e-12))
    r0s = (1.0 - ri) / (1.0 + ri)
    r0s = r0s * r0s
    one_m = 1.0 - cos_t
    schl = r0s + (1.0 - r0s) * (one_m * one_m * one_m * one_m * one_m)
    refl_choice = (ri * sin_t > 1.0) | (schl > u3)
    udn = udx * nx_ + udy * ny_ + udz * nz_
    rpx = ri * (udx + cos_t * nx_)
    rpy = ri * (udy + cos_t * ny_)
    rpz = ri * (udz + cos_t * nz_)
    spar = -jnp.sqrt(jnp.maximum(
        jnp.abs(1.0 - (rpx * rpx + rpy * rpy + rpz * rpz)), 1e-20))
    ddx = jnp.where(refl_choice, udx - 2.0 * udn * nx_, rpx + spar * nx_)
    ddy = jnp.where(refl_choice, udy - 2.0 * udn * ny_, rpy + spar * ny_)
    ddz = jnp.where(refl_choice, udz - 2.0 * udn * nz_, rpz + spar * nz_)

    def pick(lamb, metal, diel, iso):
        return jnp.where(is_lamb, lamb, jnp.where(
            is_metal, metal, jnp.where(is_diel, diel, iso)))

    ndx, ndy, ndz = pick(ldx, mdx, ddx, uvx), pick(ldy, mdy, ddy, uvy), \
        pick(ldz, mdz, ddz, uvz)
    atr = jnp.where(is_diel, 1.0, jnp.where(uses_tex, t_alr, alr))
    atg = jnp.where(is_diel, 1.0, jnp.where(uses_tex, t_alg, alg))
    atb = jnp.where(is_diel, 1.0, jnp.where(uses_tex, t_alb, alb))

    miss = alive & ~valid
    hit_live = alive & valid
    scatter_live = hit_live & ~is_light
    emit = hit_live & is_light
    rr = rr + jnp.where(miss, tpr * bg[0], 0.0) + jnp.where(emit, tpr * t_alr, 0.0)
    rg = rg + jnp.where(miss, tpg * bg[1], 0.0) + jnp.where(emit, tpg * t_alg, 0.0)
    rb = rb + jnp.where(miss, tpb * bg[2], 0.0) + jnp.where(emit, tpb * t_alb, 0.0)
    tpr = jnp.where(scatter_live, tpr * atr, tpr)
    tpg = jnp.where(scatter_live, tpg * atg, tpg)
    tpb = jnp.where(scatter_live, tpb * atb, tpb)
    o = tuple(jnp.where(scatter_live, p, c) for p, c in
              ((px, ox), (py, oy), (pz, oz)))
    d = tuple(jnp.where(scatter_live, n, c) for n, c in
              ((ndx, dx), (ndy, dy), (ndz, dz)))
    bn = bn + jnp.where(alive, 1.0, 0.0)
    # The surface the next ray leaves (as integrator._make_step): a quad
    # always, a sphere or box when the ray leaves it outward (onx.. is the
    # outward normal for both).
    leaves_out = (ndx * onx + ndy * ony + ndz * onz) > 0.0
    skip = scatter_live & ((code == 1.0) | (
        ((code == 0.0) | (code == 2.0)) & leaves_out))
    alive = scatter_live & (bn < jnp.float32(max_depth))
    return (bn, alive, o, d, (tpr, tpg, tpb), (rr, rg, rb),
            (jnp.where(skip, code, -1.0), idx))


def _camera_ray(T, xx, yy, sqrt_spp, sample_f, key):
    """In-lane Camera::GetRay (Camera.hpp:50-67) for one progressive
    sample; the jitter, disk and time draws are the camera counters of
    ``rng.murmur_uniforms``."""
    u = [_uniform(key, rng.CAMERA_CTR_BASE + k) for k in range(5)]
    k1 = jnp.floor(sample_f / sqrt_spp)
    s_i = sample_f - k1 * sqrt_spp
    s_j = k1 - jnp.floor(k1 / sqrt_spp) * sqrt_spp
    recip = 1.0 / sqrt_spp
    pxj = (s_i + u[0]) * recip - 0.5
    pyj = (s_j + u[1]) * recip - 0.5
    pc = [T(c) + (xx + pxj) * T(3 + c) + (yy + pyj) * T(6 + c)
          for c in range(3)]
    r = jnp.sqrt(u[2])
    th = jnp.float32(2.0 * 3.14159265358979) * u[3]
    dkx, dky = r * jnp.cos(th), r * jnp.sin(th)
    use_disk = T(18) > 0.0
    org = [jnp.where(use_disk, T(9 + c) + dkx * T(12 + c) + dky * T(15 + c),
                     T(9 + c)) for c in range(3)]
    dd = [pc[c] - org[c] for c in range(3)]
    inv_len = jax.lax.rsqrt(jnp.maximum(
        dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2], 1e-24))
    return tuple(org), tuple(x * inv_len for x in dd), u[4]


def _kernel(tbl_ref, seed_ref, out_r, out_g, out_b, *, sizes, max_depth,
            has_checker):
    off, _ = table_offsets(sizes)
    n_med = sizes[4]

    def T(i):       # broadcast scalar load
        return tbl_ref[i]

    def G(idx):     # per-lane gather
        return tbl_ref[idx]

    slot = (T(24).astype(jnp.int32) + pl.program_id(0) * BLOCK
            + jnp.arange(BLOCK, dtype=jnp.int32))
    width_i = T(19).astype(jnp.int32)
    yy_i = slot // width_i
    xx = (slot - yy_i * width_i).astype(jnp.float32)
    yy = yy_i.astype(jnp.float32)
    in_grid = slot < T(20).astype(jnp.int32)
    s0, n_samples, sqrt_spp = T(21), T(22), T(23)
    seed = seed_ref[0]
    bg = (T(25), T(26), T(27))

    def body(carry):
        (s_lane, bn, al, ox, oy, oz, dx, dy, dz, tm, tpr, tpg, tpb, rr, rg, rb,
         skip_code, skip_idx) = carry
        # Regenerate: a lane whose path ended starts its next sample.
        need = (al <= 0.0) & (s_lane < n_samples - 1.0) & in_grid
        s_lane = s_lane + jnp.where(need, 1.0, 0.0)
        key = sample_key(seed, slot, s0 + s_lane)
        (cox, coy, coz), (cdx, cdy, cdz), ctm = _camera_ray(
            T, xx, yy, sqrt_spp, s0 + s_lane, key)
        ox, oy, oz = (jnp.where(need, c, v) for c, v in
                      ((cox, ox), (coy, oy), (coz, oz)))
        dx, dy, dz = (jnp.where(need, c, v) for c, v in
                      ((cdx, dx), (cdy, dy), (cdz, dz)))
        tm = jnp.where(need, ctm, tm)
        bn = jnp.where(need, 0.0, bn)
        tpr, tpg, tpb = (jnp.where(need, 1.0, v) for v in (tpr, tpg, tpb))
        skip_code = jnp.where(need, -1.0, skip_code)
        alive = (al > 0.0) | need
        rec = _closest_hit(T, off, sizes, key, tm, bn, (ox, oy, oz),
                           (dx, dy, dz), (skip_code, skip_idx))
        (bn, alive, (ox, oy, oz), (dx, dy, dz), (tpr, tpg, tpb), (rr, rg, rb),
         (skip_code, skip_idx)) = _shade(
            T, G, off, key, bn, alive, (ox, oy, oz), (dx, dy, dz),
            (tpr, tpg, tpb), (rr, rg, rb), rec, bg,
            has_checker=has_checker, n_med=n_med, max_depth=max_depth)
        return (s_lane, bn, alive.astype(jnp.float32), ox, oy, oz, dx, dy, dz,
                tm, tpr, tpg, tpb, rr, rg, rb, skip_code, skip_idx)

    def cond(carry):
        s_lane, al = carry[0], carry[2]
        runnable = (al > 0.0) | ((s_lane < n_samples - 1.0) & in_grid)
        return jnp.sum(jnp.where(runnable, 1.0, 0.0)) > 0.0

    zero = jnp.zeros((BLOCK,), jnp.float32)
    init = ((jnp.full((BLOCK,), -1.0, jnp.float32),) + (zero,) * 15
            + (jnp.full((BLOCK,), -1.0, jnp.float32), zero))
    final = jax.lax.while_loop(cond, body, init)
    out_r[...] = final[13]
    out_g[...] = final[14]
    out_b[...] = final[15]


@functools.partial(
    jax.jit,
    static_argnames=("n_slots", "sizes", "max_depth", "has_checker",
                     "interpret"),
)
def render_slots(table, seed, *, n_slots, sizes, max_depth, has_checker,
                 interpret=False):
    """Radiance SUM over the batch's samples for ``n_slots`` consecutive
    pixel slots starting at the table's slot offset (header entry 24):
    [n_slots, 3]. Slots past the image (header entry 20) stay zero.
    ``table`` comes from ``pack_table``; ``seed`` is the exact i32 render
    seed (the f32 table cannot carry seed·1000003). ``interpret`` runs the
    kernel in the Pallas interpreter — CPU tests only."""
    if n_slots % BLOCK:
        raise ValueError(f"n_slots {n_slots} is not a multiple of {BLOCK}")
    kernel = functools.partial(
        _kernel, sizes=tuple(sizes), max_depth=max_depth,
        has_checker=int(has_checker))
    spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    outs = pl.pallas_call(
        kernel,
        grid=(n_slots // BLOCK,),
        out_specs=(spec, spec, spec),
        out_shape=tuple(jax.ShapeDtypeStruct((n_slots,), jnp.float32)
                        for _ in range(3)),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="rt_megakernel",
    )(table, jnp.asarray(seed, jnp.int32).reshape(1))
    return jnp.stack(outs, axis=-1)


def header(scene, width, height, sample0, n_samples, sqrt_spp, slot0=0):
    """The HEADER_LEN control entries for one dispatch."""
    frame = camera_ops.camera_frame(scene.camera, width, height)
    return jnp.concatenate([
        frame["pixel00"], frame["pixel_delta_u"], frame["pixel_delta_v"],
        frame["center"], frame["defocus_disk_u"], frame["defocus_disk_v"],
        jnp.stack([
            jnp.asarray(frame["defocus_angle"], jnp.float32),
            jnp.float32(width), jnp.float32(width * height),
            jnp.asarray(sample0, jnp.float32),
            jnp.asarray(n_samples, jnp.float32),
            jnp.float32(sqrt_spp), jnp.asarray(slot0, jnp.float32),
        ]),
        scene.background,
    ]).astype(jnp.float32)


def n_slots_for(n_pixels: int, parts: int = 1) -> int:
    """Slots per part when ``n_pixels`` are split into ``parts`` equal
    block-aligned ranges."""
    return -(-n_pixels // (parts * BLOCK)) * BLOCK
