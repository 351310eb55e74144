"""The port's on-disk pipeline against the JAX package's, on the CPU.

The scene and the reference-style config are `tests/test_pipeline.py`'s
fixtures. Both packages read them:
  * data: `GSDataModule` on the static and the dynamic block, with and
    without camera normalisation: frames (image, depth, mask, time) equal,
    fovx / fovy to 1e-6 relative (the JAX package's float32 `tan` / `atan`
    come from XLA, whose results differ from every other float32
    implementation in the last bit for about a fifth of the inputs; the port
    computes them in float64), q_c2w / t_c2w 1e-6, normalisation and initial
    point cloud equal, three epochs of sampler order equal;
  * config: every target of every shipped YAML resolves to a port class;
  * build: `build_training_run` gives the JAX package's initial stores
    (equal but for the KNN scale prior, which both packages must compute
    to within its float32 rounding bound, see `_cmp_store`), poses and
    trainer configs;
  * CLIs: the port's train CLI on the CPU for 30 iterations, then both
    packages' eval CLIs on its run directory (`eval_wo_align.yaml`): PSNR /
    SSIM 1e-4, ATE / RPE 1e-6, the PNGs and `video.mp4`;
  * resume: a port run resumed by a fresh one, and resume files in both
    directions between the packages, with equal state;
  * `data/synthetic.py`'s scene read by both datamodules.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax

from rodygs_tpu.pipelines import build as jbuild
from rodygs_tpu.pipelines import eval as jeval_cli
from rodygs_tpu.utils import config as jconfig
from rodygs_tpu_torch import convert
from rodygs_tpu_torch.data import synthetic
from rodygs_tpu_torch.pipelines import build as tbuild
from rodygs_tpu_torch.pipelines import eval as teval_cli
from rodygs_tpu_torch.pipelines import train as ttrain_cli
from rodygs_tpu_torch.utils import config as tconfig
from rodygs_tpu_torch.utils import native as tnative

from test_pipeline import scene_dir, train_config  # noqa: F401 (fixtures)
from test_reference_configs import iter_targets
from test_torch_dynamic import _flat

REPO = Path(__file__).resolve().parents[1]
SHIPPED_YAMLS = sorted((REPO / "configs").glob("*/*.yaml"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread here: the suite runs several worker processes
    on the same cores, and torch's OpenMP barriers, each waiting for
    descheduled threads, made the train CLI's 30 small iterations take
    minutes under that load instead of seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _host_ops_loaded():
    """Both packages' native host-ops library loaded before any frame is
    read. The JAX package's loader is not thread-safe: frame-loader threads
    that call in while the first one loads the library take the numpy
    path, whose u8 -> f32 conversion rounds differently in the last bit."""
    from rodygs_tpu.utils import native as jnative

    jnative.get_lib()
    tnative.get_lib()


def _block(train_config, name, normalize_cams):
    cfg = json.loads(json.dumps(train_config[name]))
    cfg["params"]["normalize_cams"] = normalize_cams
    return cfg


def _datamodules(train_config, name, normalize_cams, **kw):
    cfg = _block(train_config, name, normalize_cams)
    return (jconfig.instantiate_from_config(cfg, **kw),
            tconfig.instantiate_from_config(cfg, **kw))


def _assert_frames_equal(jd, td):
    assert len(jd) == len(td) and len(td) > 0
    assert (td.image_height, td.image_width) == (jd.image_height,
                                                 jd.image_width)
    for jf, tf in zip(jd.frames, td.frames):
        assert sorted(tf) == sorted(jf)
        for k in ("image", "depth", "normal", "motion_mask", "max_depth"):
            if jf[k] is None:
                assert tf[k] is None, k
            else:
                assert tf[k].dtype == jf[k].dtype, k
                np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)
        for k in ("image_name", "time", "cam_idx"):
            assert tf[k] == jf[k], k
        for k in ("fovx", "fovy"):
            np.testing.assert_allclose(tf[k], jf[k], rtol=1e-6, err_msg=k)


def _assert_poses_close(jd, td):
    np.testing.assert_allclose(td.q_c2w, np.asarray(jd.q_c2w), atol=1e-6)
    np.testing.assert_allclose(td.t_c2w, np.asarray(jd.t_c2w), atol=1e-6)
    np.testing.assert_allclose(td.get_poses(), np.asarray(jd.get_poses()),
                               atol=1e-6)


def _assert_pcd_equal(jp, tp):
    for k in ("points", "colors", "normals", "time"):
        np.testing.assert_array_equal(getattr(tp, k), getattr(jp, k),
                                      err_msg=k)


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------


@pytest.mark.parametrize("normalize_cams", [False, True])
@pytest.mark.parametrize("block", ["static_data", "dynamic_data"])
def test_datamodule_matches(scene_dir, train_config, block,  # noqa: F811
                            normalize_cams):
    jdm, tdm = _datamodules(train_config, block, normalize_cams)
    assert tdm.skip_dynamic == jdm.skip_dynamic is False
    for split in ("get_train_dset", "get_test_dset"):
        jd, td = getattr(jdm, split)(), getattr(tdm, split)()
        assert type(td).__name__ == type(jd).__name__
        _assert_frames_equal(jd, td)
        _assert_poses_close(jd, td)
    jn, tn = jdm.get_normalization(), tdm.get_normalization()
    np.testing.assert_array_equal(tn["translate"], jn["translate"])
    assert tn["radius"] == jn["radius"]
    _assert_pcd_equal(jdm.get_init_pcd(), tdm.get_init_pcd())
    n = len(tdm.get_train_dset())
    for jdl, tdl, count in ((jdm.get_train_sampler(),
                             tdm.get_train_sampler(), 3 * n),
                            (jdm.get_test_sampler(), tdm.get_test_sampler(),
                             None)):
        ji, ti = iter(jdl), iter(tdl)
        want = [int(i) for i in (list(ji) if count is None
                                 else [next(ji) for _ in range(count)])]
        got = [int(i) for i in (list(ti) if count is None
                                else [next(ti) for _ in range(count)])]
        assert got == want


def test_native_host_ops_match_numpy_and_jax():
    from rodygs_tpu.utils import native as jnative

    rng = np.random.default_rng(3)
    rgba = rng.integers(0, 256, (7, 5, 4), dtype=np.uint8)
    img = rng.uniform(-0.1, 1.1, (7, 5, 3)).astype(np.float32)
    depth = rng.uniform(1, 5, (7, 5)).astype(np.float32)
    assert tnative.backend() == "native"
    cases = [("composite_rgba_to_rgb", rgba), ("u8_rgb_to_f32", rgba[..., :3]),
             ("negate_minmax_normalize", depth),
             ("f32_rgb_to_u16_bgr", img)]
    for name, x in cases:
        got = getattr(tnative, name)(x)
        np.testing.assert_array_equal(got, getattr(jnative, name)(x),
                                      err_msg=name)
        lib, tnative._LIB = tnative._LIB, None   # the numpy fallback
        try:
            np.testing.assert_allclose(getattr(tnative, name)(x), got,
                                       atol=1e-6, rtol=0, err_msg=name)
        finally:
            tnative._LIB = lib


# --------------------------------------------------------------------------
# config
# --------------------------------------------------------------------------


@pytest.mark.parametrize("yaml_path", SHIPPED_YAMLS,
                         ids=lambda p: f"{p.parent.name}/{p.stem}")
def test_every_shipped_target_resolves_to_the_port(yaml_path):
    from rodygs_tpu_torch.train.losses import _LOSS_REGISTRY

    targets = list(iter_targets(tconfig.load_yaml(str(yaml_path))))
    assert targets, yaml_path
    for where, tgt in targets:
        if tgt.startswith("src.trainer.losses.") and not tgt.endswith(
                "MultiLoss"):
            assert tgt.rsplit(".", 1)[-1] in _LOSS_REGISTRY, (where, tgt)
            continue
        obj = tconfig.get_obj_from_str(tgt)
        assert obj.__module__.startswith("rodygs_tpu_torch."), (where, tgt)


def test_config_refuses_jax_targets_and_merges_like_jax():
    with pytest.raises(ValueError, match="JAX package"):
        tconfig.get_obj_from_str("rodygs_tpu.data.datamodule.GSDataModule")
    a = {"x": {"y": 1, "z": [1, 2]}, "w": 3}
    b = {"x": {"y": 5}, "v": {"u": None}}
    dots = ["x.q.r=0.5", "w=[1, 2]", "--v.u=true"]
    assert (tconfig.apply_dotlist(tconfig.merge_configs(a, b), dots)
            == jconfig.apply_dotlist(jconfig.merge_configs(a, b), dots))
    for v in ("yes", "0", "F", True):
        assert tconfig.str2bool(v) == jconfig.str2bool(v)


# --------------------------------------------------------------------------
# build
# --------------------------------------------------------------------------


def _knn_exact(points, k=3):
    """Mean squared distance to the k nearest other points, in float64."""
    p = points.astype(np.float64)
    d = ((p[:, None] - p[None]) ** 2).sum(-1)
    return np.sort(d, axis=1)[:, 1:k + 1].mean(1)


def _cmp_store(jstore, tstore, what, points):
    """Stores equal but for the KNN scale prior. That prior is
    log(sqrt(mean squared distance to the 3 nearest points)), each squared
    distance summed in float32 as |x|^2 + |y|^2 - 2 x.y: its rounding error
    reaches a few float32 eps of |x|^2, whatever the distance, and XLA and
    torch sum in different orders. So both packages' squared distances must
    lie within 16 eps max|x|^2 of the exact (float64) value, clamped at
    1e-7 as the prior clamps it. (The scene writes the same static cloud
    for every frame: where a point's 3 nearest are its own copies, the
    distance is rounding noise alone.)"""
    jf = _flat(jstore, what)
    tf = _flat(convert.store_to_numpy(tstore), what)
    assert sorted(jf) == sorted(tf)
    n = len(points)
    exact = np.maximum(_knn_exact(points), 1e-7)
    tol = 16 * np.finfo(np.float32).eps * (points.astype(np.float64) ** 2
                                           ).sum(1).max()
    for k in jf:
        assert tf[k].shape == jf[k].shape and tf[k].dtype == jf[k].dtype, k
        if k.endswith("scaling"):
            for side in (jf[k], tf[k]):
                sq = np.exp(2.0 * side[:n].astype(np.float64))
                np.testing.assert_allclose(sq, exact[:, None].repeat(
                    side.shape[1], 1), rtol=1e-5, atol=tol, err_msg=k)
            np.testing.assert_array_equal(tf[k][n:], jf[k][n:], err_msg=k)
        else:
            np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)


def test_build_training_run_matches(scene_dir, train_config):  # noqa: F811
    kw = dict(dirpath=str(scene_dir), logdir=None, seed=3,
              capacity_factor=2.0)
    jrun = jbuild.build_training_run(train_config, **kw)
    trun = tbuild.build_training_run(train_config, device="cpu", **kw)
    assert trun.num_iterations == jrun.num_iterations == 30
    assert trun.log_freq == jrun.log_freq == 10
    jj, tj = jrun.joint, trun.joint
    assert (tj.sh_up_start_iteration, tj.sh_up_period, tj.log_freq) == (
        jj.sh_up_start_iteration, jj.sh_up_period, jj.log_freq)
    for side in ("static", "dynamic"):
        jt, tt = getattr(jj, side), getattr(tj, side)
        assert dataclass_dict(tt.cfg) == dataclass_dict(jt.cfg), side
        assert tt.spatial_lr_scale == jt.spatial_lr_scale
        assert [(t.name, t.weight, t.fn_name, t.freq, t.start, t.params)
                for t in tt.loss.terms] == [
            (t.name, t.weight, t.fn_name, t.freq, t.start, t.params)
            for t in jt.loss.terms]
        dm = trun.static_dm if side == "static" else trun.dynamic_dm
        _cmp_store(jt.state.store, tt.state.store, side,
                   dm.get_init_pcd().points)
    jp, tp = jj.static.state.poses, tj.static.state.poses
    np.testing.assert_allclose(tp.q_c2w.numpy(), np.asarray(jp.q_c2w),
                               atol=1e-6)
    np.testing.assert_array_equal(tp.t_c2w.numpy(), np.asarray(jp.t_c2w))
    np.testing.assert_array_equal(tj.dynamic.unique_times.numpy(),
                                  np.asarray(jj.dynamic.unique_times))
    # the motion nets are drawn from different generators: same shapes
    jn, tn = _flat(jj.dynamic.state.net), _flat(tj.dynamic.state.net)
    assert {k: v.shape for k, v in tn.items()} == {
        k: v.shape for k, v in jn.items()}


def dataclass_dict(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def test_make_frame_batch_matches(scene_dir, train_config):  # noqa: F811
    jdm, tdm = _datamodules(train_config, "dynamic_data", False)
    frame = tdm.get_train_dset()[2]
    jb = jbuild.make_frame_batch(jdm.get_train_dset()[2], 2)
    tb = tbuild.make_frame_batch(frame, 2, "cpu")
    assert tb.frame_idx == int(jb.frame_idx) == 2
    for k in ("gt_image", "gt_depth", "motion_mask", "time"):
        assert getattr(tb, k).dtype == torch.float32, k
        np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                      np.asarray(getattr(jb, k)), err_msg=k)
    for k in ("fovx", "fovy"):
        np.testing.assert_allclose(getattr(tb, k).numpy(),
                                   np.asarray(getattr(jb, k)), rtol=1e-6)


# --------------------------------------------------------------------------
# the CLIs
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_run(scene_dir, train_config, tmp_path_factory):  # noqa: F811
    """The port's train CLI on the CPU, 30 iterations, a snapshot every 15."""
    root = tmp_path_factory.mktemp("port_run")
    cfg_path = root / "cfg.yaml"
    cfg_path.write_text(yaml.dump(train_config))
    # a stale build output must stay out of the code snapshot
    build = Path(ttrain_cli.__file__).resolve().parents[1] / "_build"
    build.mkdir(exist_ok=True)
    run = ttrain_cli.main([
        "-d", str(scene_dir), "-b", str(cfg_path), "-g", "grp", "-n", "run",
        "-l", str(root / "logs"), "-s", "1", "--capacity_factor", "2.0",
        "--checkpoint_every", "15", "--device", "cpu"])
    return root / "logs" / "grp" / "run_1", run


def test_train_cli_writes_the_run(port_run):
    modeldir, run = port_run
    train = modeldir / "train"
    for name in ("static_last.ckpt", "dynamic_last.ckpt", "resume.ckpt",
                 "config.yaml", "args.yaml", "train.log"):
        assert (train / name).exists(), name
    code = train / "code" / "rodygs_tpu_torch"
    assert (code / "pipelines" / "train.py").exists()
    assert not list(code.rglob("_build")) and not list(
        code.rglob("__pycache__"))
    log = (train / "train.log").read_text()
    assert "[30/30]" in log and "step times" in log
    assert '"expand": 0' in log    # CPU tensors never launch a kernel
    assert run.joint.static.device.type == "cpu"
    losses = [float(line.split(" static ")[1].split()[0])
              for line in log.splitlines() if " static " in line]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_eval_clis_agree_on_the_port_run(port_run, scene_dir, capsys):  # noqa: F811
    modeldir, _ = port_run
    cfg = str(REPO / "configs" / "eval" / "eval_wo_align.yaml")
    common = ["-c", cfg, "-d", str(scene_dir), "-m", str(modeldir),
              "--eval_batch_size", "2"]
    got = teval_cli.main(common + ["-t", "eval_port", "--device", "cpu"])
    assert '"tile_fwd": 0' in capsys.readouterr().out
    jeval_cli.main(common + ["-t", "eval_jax"])
    want = yaml.safe_load((modeldir / "eval_jax" / "result.yaml").read_text())
    assert yaml.safe_load(
        (modeldir / "eval_port" / "result.yaml").read_text()) == got
    for k in ("psnr", "ssim"):
        np.testing.assert_allclose(got["viz"][k], want["viz"][k], atol=1e-4,
                                   err_msg=k)
    assert set(got["viz"]) == set(want["viz"])
    for k in ("ATE", "RPE_trans", "RPE_rot"):
        np.testing.assert_allclose(got["pose"][k], want["pose"][k],
                                   atol=1e-6, err_msg=k)
    assert got["viz"]["psnr"] > 10.0
    for task in ("eval_port", "eval_jax"):
        out = modeldir / task
        assert (out / "video.mp4").stat().st_size > 0, task
        for sub in ("gt", "pred"):
            assert len(list((out / sub / "viz").glob("*.png"))) == 5


def test_ckpt_camera_reader_reads_both_packages_files(port_run, scene_dir,  # noqa: F811
                                                     tmp_path):
    """`MASt3R_CKPTCameraReader` on a port-written checkpoint (the train
    CLI's) and on one the JAX package writes, against the JAX reader."""
    from rodygs_tpu.data import readers as jreaders
    from rodygs_tpu.utils import checkpoint as jckpt
    from rodygs_tpu_torch.data import readers as treaders

    port_file = port_run[0] / "train" / "static_last.ckpt"
    sd, _ = jckpt.load_checkpoint(port_file)
    jax_file = tmp_path / "jax_static.ckpt"
    jckpt.save_checkpoint(jax_file, {"camera": {
        k: np.asarray(v) + 0.01 for k, v in sd["camera"].items()}}, 5)
    kw = dict(dirpath=str(scene_dir), mast3r_expname="exp0",
              mast3r_img_res=512)
    for path in (port_file, jax_file):
        want = jreaders.MASt3R_CKPTCameraReader(ckpt_path=str(path), **kw)
        got = treaders.MASt3R_CKPTCameraReader(ckpt_path=str(path), **kw)
        for i in range(5):
            np.testing.assert_allclose(got.get_poses(i), want.get_poses(i),
                                       atol=1e-6)
        np.testing.assert_allclose(got.get_fovx(0), want.get_fovx(0),
                                   rtol=1e-6)
    assert not np.allclose(
        treaders.MASt3R_CKPTCameraReader(ckpt_path=str(jax_file),
                                         **kw).get_poses(0),
        treaders.MASt3R_CKPTCameraReader(ckpt_path=str(port_file),
                                         **kw).get_poses(0))


def test_clis_need_a_card_or_the_cpu_asked_for(scene_dir, tmp_path,  # noqa: F811
                                               monkeypatch):
    args = ["-d", str(scene_dir), "-b", str(REPO / "configs" / "train" /
                                            "train_synthetic_small.yaml"),
            "-n", "x", "-l", str(tmp_path)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain_cli.main(args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        teval_cli.main(["-c", "x.yaml", "-d", str(scene_dir), "-m",
                        str(tmp_path)])
    # a mesh larger than the process world is refused before any output
    with pytest.raises(ValueError, match="mesh 2x1x1 != 1 processes"):
        ttrain_cli.main(args + ["--device", "cpu", "--mesh", "data=2"])
    assert not (tmp_path / "default").exists()


# --------------------------------------------------------------------------
# resume
# --------------------------------------------------------------------------


def _assert_states_equal(a, b, what):
    fa, fb = _flat(a, what), _flat(b, what)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fb[k], fa[k], err_msg=k)


def _port_states(run):
    j = run.joint
    return (j.static.state, j.dynamic.state, j.static.active_sh_degree,
            j.dynamic.active_sh_degree, j.dynamic.unique_times)


def test_port_resume_roundtrip(scene_dir, train_config, tmp_path):  # noqa: F811
    kw = dict(dirpath=str(scene_dir), logdir=tmp_path, seed=3,
              capacity_factor=2.0, device="cpu")
    run = tbuild.build_training_run(train_config, **kw)
    run.num_iterations, run.checkpoint_every = 12, 6
    run.train()
    gens = (run.joint.static.gen.get_state(), run.joint.dynamic.gen.get_state())

    run2 = tbuild.build_training_run(train_config, **kw)
    # the rigidity term drew from the dynamic generator
    assert not torch.equal(run2.joint.dynamic.gen.get_state(), gens[1])
    assert run2.joint.load_resume(tmp_path / "resume.ckpt") == 13
    for a, b, what in zip(_port_states(run), _port_states(run2),
                          ("static", "dynamic", "sh", "sh", "times")):
        _assert_states_equal(a, b, what)
    assert torch.equal(run2.joint.static.gen.get_state(), gens[0])
    assert torch.equal(run2.joint.dynamic.gen.get_state(), gens[1])
    # the resume path of train(): nothing left to run, the end checkpoints
    run2.num_iterations = 12
    run2.train(resume=True)
    assert (tmp_path / "static_last.ckpt").exists()


def _jax_states(run):
    j = run.joint
    return (j.static.state, j.dynamic.state, j.static.active_sh_degree,
            j.dynamic.active_sh_degree, j.dynamic.unique_times)


def test_resume_files_cross_between_the_packages(scene_dir, train_config,  # noqa: F811
                                                 tmp_path):
    kw = dict(dirpath=str(scene_dir), logdir=tmp_path, seed=3,
              capacity_factor=2.0)
    jrun = jbuild.build_training_run(train_config, **kw)
    trun = tbuild.build_training_run(train_config, device="cpu", **kw)
    # distinct states on the two sides, so a load is seen to move them
    trun.joint.dynamic.state = trun.joint.dynamic.state._replace(
        motion_coeff=trun.joint.dynamic.state.motion_coeff + 0.25)
    trun.joint.static.active_sh_degree = 1

    jrun.joint.save_resume(tmp_path / "jax.ckpt", 40, jax.random.key(3))
    assert trun.joint.load_resume(tmp_path / "jax.ckpt") == 41
    for a, b, what in zip(_jax_states(jrun), _port_states(trun),
                          ("static", "dynamic", "sh", "sh", "times")):
        _assert_states_equal(a, b, what)

    trun.joint.dynamic.state = trun.joint.dynamic.state._replace(
        motion_coeff=trun.joint.dynamic.state.motion_coeff - 0.5)
    trun.joint.static.active_sh_degree = 2
    trun.joint.save_resume(tmp_path / "port.ckpt", 17)
    nxt, key = jrun.joint.load_resume(tmp_path / "port.ckpt")
    assert nxt == 18
    np.testing.assert_array_equal(jax.random.key_data(key), [0, 3])
    for a, b, what in zip(_port_states(trun), _jax_states(jrun),
                          ("static", "dynamic", "sh", "sh", "times")):
        _assert_states_equal(a, b, what)


# --------------------------------------------------------------------------
# the synthetic scene writer
# --------------------------------------------------------------------------


def test_synthetic_scene_reads_alike(tmp_path):
    scene = synthetic.make_scene_views(60, 15, 3, 32, 32, device="cpu",
                                       test_times=(0.25,))
    root = synthetic.write_scene(tmp_path / "scene", scene, 32, 32,
                                 pose_noise_rot_deg=0.3,
                                 pose_noise_trans=0.01)
    exp = root / "mast3r_opt" / "exp0"
    assert len(list((exp / "static").glob("*.ply"))) == 3
    assert len(list((exp / "dynamic").glob("*.ply"))) == 3
    test_json = json.loads((root / "test_transforms.json").read_text())
    assert [f["time"] for f in test_json["frames"]] == [0.25]
    cfg = yaml.safe_load((REPO / "configs" / "train" /
                          "train_synthetic_small.yaml").read_text())
    for block in ("static_data", "dynamic_data"):
        jdm, tdm = (mod.instantiate_from_config(cfg[block],
                                                dirpath=str(root))
                    for mod in (jconfig, tconfig))
        for split in ("get_train_dset", "get_test_dset"):
            jd, td = getattr(jdm, split)(), getattr(tdm, split)()
            _assert_frames_equal(jd, td)
            _assert_poses_close(jd, td)
        _assert_pcd_equal(jdm.get_init_pcd(), tdm.get_init_pcd())
    img = tdm.get_train_dset()[1]["image"]
    assert img.shape == (32, 32, 3) and 0.05 < img.mean() < 0.95
