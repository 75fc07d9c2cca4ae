"""The port's dataset layer (``data/dataset.py``) against the JAX
package's on the CPU: a dataset written by ``cwfa_tpu.data.
make_synthetic_dataset`` read by both ``load_xlfm_data`` gives equal camera
views, volumes and statistics.  The three faults of the reference that the
port does not carry over (ROADMAP C) are asserted on the port alone: the
float16 clip after the NaN/Inf scrub, a version bumped by every in-place
mutation, and a tag of its own for every dataset object."""

import gc
import os

import numpy as np
import pytest

from cwfa_tpu import data as jdata

from cwfa_tpu_torch.data import dataset as tds
from cwfa_tpu_torch.data.stats import DatasetStatistics
from cwfa_tpu_torch.data.tiff import write_tiff_stack

N_DEPTHS, VOL_SIDE, IMG, NLENS, VIEW = 16, 32, 96, 4, 32


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_ds"))
    info = jdata.make_synthetic_dataset(root, n_fish=2, n_frames=3,
                                        n_depths=N_DEPTHS, vol_side=VOL_SIDE,
                                        img_size=IMG, n_lenslets=NLENS,
                                        view_size=VIEW)
    return info


def _load(pkg, info, fish, frames=(0, 1, 2), **kw):
    return pkg.load_xlfm_data(
        info["fish_dirs"][fish] + "/SLNet_preprocessed", info["lenslet_file"],
        vol_shape=(VOL_SIDE, VOL_SIDE, N_DEPTHS), img_shape=(IMG, IMG),
        images_to_use=list(frames), n_depths_to_fill=N_DEPTHS,
        ds_id=f"fish_{fish}", **kw)


@pytest.mark.parametrize("norm", [None, "max", "std"])
def test_load_xlfm_data_matches_jax(synth, norm):
    mine = [_load(tds, synth, f, norm=norm) for f in (0, 1)]
    ref = [_load(jdata, synth, f, norm=norm) for f in (0, 1)]
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.stacked_views, b.stacked_views)
        assert a.vols.dtype == b.vols.dtype
        np.testing.assert_array_equal(a.vols, b.vols)
        np.testing.assert_array_equal(a.lenslet_coords, b.lenslet_coords)
        assert a.images_to_use == b.images_to_use
    cat, jcat = tds.ConcatXLFMDataset(*mine), jdata.ConcatXLFMDataset(*ref)
    assert len(cat) == len(jcat) == 6
    assert cat.get_statistics().astuple() == jcat.get_statistics().astuple()
    for di in (0, 1):
        np.testing.assert_array_equal(cat.mean_volume(di),
                                      jcat.mean_volume(di))
    for ix in range(-6, 6):
        assert cat.locate(ix) == jcat.locate(ix)
    assert cat.get_max() == list(jcat.get_max())


def test_out_of_range_frames_are_skipped_as_jax_skips_them(synth):
    with pytest.warns(UserWarning):
        mine = _load(tds, synth, 0, frames=(2, 7, 0))
    ref = _load(jdata, synth, 0, frames=(2, 7, 0))
    assert mine.images_to_use == ref.images_to_use == [2, 0]
    np.testing.assert_array_equal(mine.vols, ref.vols)


def test_scrub_then_clip_to_float16(synth, tmp_path):
    """A finite voxel above 65504 stays finite (the reference's f16 store
    makes it +inf); NaN and Inf become 0."""
    fish = tmp_path / "fish"
    os.makedirs(fish / "XLFM_image")
    os.makedirs(fish / "XLFM_stack")
    write_tiff_stack(str(fish / "XLFM_image" / "XLFM_image_stack.tif"),
                     np.ones((1, IMG, IMG), np.float32))
    vol = np.ones((N_DEPTHS, VOL_SIDE, VOL_SIDE), np.float32)
    vol[0, 0, 0], vol[1, 0, 0], vol[2, 0, 0] = 7e4, np.nan, np.inf
    write_tiff_stack(str(fish / "XLFM_stack" / "XLFM_stack_000.tif"), vol)
    ds = tds.XLFMDataset(str(fish), synth["lenslet_file"], (IMG, IMG),
                         n_depths_to_fill=N_DEPTHS)
    assert ds.vols.dtype == np.float16
    assert np.isfinite(ds.vols).all()
    assert ds.vols[0, 0, 0, 0] == np.float16(65504)
    assert ds.vols[0, 1, 0, 0] == 0 and ds.vols[0, 2, 0, 0] == 0


def test_mutations_bump_the_version_and_the_cache_tag(synth):
    a = _load(tds, synth, 0)
    cat = tds.ConcatXLFMDataset(a)
    tag = cat.cache_tag
    a.standardize(DatasetStatistics(1.0, 2.0, 1.0, 2.0, 3.0, 4.0))
    assert a.version == 1 and cat.cache_tag != tag
    tag = cat.cache_tag
    cat.add_random_shot_noise_to_dataset(rng=0)
    assert a.version == 2 and cat.cache_tag != tag
    tag = cat.cache_tag
    cat.normalize_datasets()
    assert a.version == 3 and cat.cache_tag != tag


def test_every_dataset_object_has_a_tag_of_its_own(synth):
    a = _load(tds, synth, 0)
    first = tds.ConcatXLFMDataset(a)
    again = tds.ConcatXLFMDataset(a)
    assert first.cache_tag != again.cache_tag
    seen = {first.cache_tag, again.cache_tag}
    del first, again
    gc.collect()
    # ids of dead objects are reused by CPython; the tags are not
    for _ in range(20):
        seen_len = len(seen)
        seen.add(tds.ConcatXLFMDataset(a).cache_tag)
        assert len(seen) == seen_len + 1
