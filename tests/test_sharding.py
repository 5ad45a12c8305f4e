"""Multi-device tests on the virtual 8-device CPU mesh (the same code path
as several cards; SURVEY.md §4 item 5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytrace2 import render as render_mod
from raytrace2.ops import integrator
from raytrace2.parallel import sharding
from raytrace2.scene import loader, schema

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@pytest.fixture(scope="module")
def cornell(data_dir):
    scene, _ = loader.load_scene(f"{data_dir}/cornell_box_original.json")
    return schema.to_device(scene), tuple(sorted(scene.features().items()))


def _single_device_reference(scene, features, width, height, samples, seed):
    out = jnp.zeros((height, width, 3))
    for s in range(samples):
        out = out + integrator.render_sample(
            scene, dict(features), width, height, jnp.int32(s), seed, 4, 1
        )
    return np.asarray(out)


def test_sharded_matches_single_device(cornell):
    """dp×sp sharded render must equal the sequential single-device render
    bit-for-bit in structure (same (pixel, sample) key set → same rays)."""
    scene, features = cornell
    w = h = 16
    mesh = sharding.make_mesh(sp=2)
    sharded = np.asarray(
        sharding.render_samples_sharded(
            scene, features, jnp.int32(0), 0,
            width=w, height=h, max_depth=4, sqrt_spp=1,
            samples_per_device=2, mesh=mesh,
        )
    )
    reference = _single_device_reference(scene, features, w, h, 4, 0)
    np.testing.assert_allclose(sharded, reference, rtol=2e-4, atol=2e-5)


def test_layout_invariance(cornell):
    """Different mesh layouts must give identical results (RNG is a pure
    function of pixel/sample identity, never device id)."""
    scene, features = cornell
    w = h = 16
    kw = dict(width=w, height=h, max_depth=4, sqrt_spp=1)
    a = np.asarray(
        sharding.render_samples_sharded(
            scene, features, jnp.int32(0), 0,
            samples_per_device=4, mesh=sharding.make_mesh(sp=1), **kw,
        )
    )
    b = np.asarray(
        sharding.render_samples_sharded(
            scene, features, jnp.int32(0), 0,
            samples_per_device=1, mesh=sharding.make_mesh(sp=4, dp=2), **kw,
        )
    )
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def test_train_step_analog_accumulates(cornell):
    scene, features = cornell
    w = h = 8
    mesh = sharding.make_mesh(sp=2)
    state = render_mod.init_state(w, h)
    state = sharding.train_step_analog(
        scene, features, state, 0,
        width=w, height=h, max_depth=3, sqrt_spp=1,
        samples_per_device=2, mesh=mesh,
    )
    assert int(state.frame_idx) == 4
    assert np.isfinite(np.asarray(state.accum)).all()


@pytest.mark.parametrize("w,h", [(8, 8), (9, 7)])
def test_distributed_gradient_matches_single_device(cornell, w, h):
    """Pixel-sharded value_and_grad with psum == single-device gradient.
    (9, 7) = 63 pixels over 8 devices: the padded rows must be weighted out
    of the loss, not double-counted."""
    import dataclasses

    from raytrace2 import grad as grad_mod

    scene, features = cornell
    kw = dict(width=w, height=h, max_depth=3, sqrt_spp=1, n_samples=2)
    target = jnp.zeros((h, w, 3))

    mesh = sharding.make_mesh(sp=2)
    loss_d, g_d = sharding.render_grad_sharded(
        scene, features, target, 0, mesh=mesh, **kw
    )

    def loss_fn(img):
        return jnp.sum((img - target) ** 2)

    loss_s, g_s = grad_mod.value_and_grad_scene(
        loss_fn, scene, features, 0, **kw
    )
    np.testing.assert_allclose(float(loss_d), float(loss_s), rtol=1e-4)
    np.testing.assert_allclose(
        np.asarray(g_d.materials.albedo), np.asarray(g_s.materials.albedo),
        rtol=1e-3, atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(g_d.background), np.asarray(g_s.background),
        rtol=1e-3, atol=1e-6,
    )
    del dataclasses


@pytest.mark.kernel
@pytest.mark.parametrize("sp,dp", [(1, 8), (2, 4), (4, 2)])
def test_sharded_megakernel_matches_single_device(cornell, sp, dp):
    """Megakernel under shard_map (block-aligned pixel-slot ranges with
    global offsets + sample psum) == the single-device kernel render,
    BITWISE for dp-only meshes: RNG streams are keyed by (pixel, sample)
    only, so the mesh layout must be invisible in the image."""
    scene, features = cornell
    feat = dict(features, use_megakernel=True, mega_interpret=True)
    w = h = 16

    single = np.asarray(
        jax.jit(
            lambda s: integrator.render_progressive(
                s, feat, w, h, jnp.int32(0), jnp.int32(4), 0, 5, 2
            )
        )(scene)
    )
    mesh = sharding.make_mesh(sp=sp, dp=dp)
    shard = np.asarray(
        sharding.render_samples_sharded_mega(
            scene, tuple(sorted(feat.items())), jnp.int32(0), 0,
            width=w, height=h, max_depth=5, sqrt_spp=2,
            samples_per_device=4 // sp, mesh=mesh,
        )
    )
    if sp == 1:
        # No cross-device sample reduction: per-pixel sums are the same f32
        # additions in the same order as the single-device batch.
        assert np.array_equal(shard, single), "dp-only layout must be bitwise"
    else:
        # psum across sp reorders the sample additions; f32 tolerance only.
        np.testing.assert_allclose(shard, single, rtol=1e-5, atol=1e-6)


def test_dryrun_multichip_entrypoint():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)
