"""Command-line tools of the port: the counterparts of the `scripts/` that
import the JAX package. Each runs as `python -m rodygs_tpu_torch.tools.<name>`:

  flagship_1080p          the joint run at 1920x1080 with 2 x 120,000 gaussians
  profile_step            steady-state step time and the device's top ops
  mast3r_unproject        MASt3R depth maps -> static / dynamic init PLYs
  mast3r_driver           the MASt3R alignment driver's logic (a library)
  run_mast3r              the MASt3R runner (needs the external network)
  convert_reference_ckpt  reference torch checkpoints -> the v2 format
  img2video               frames -> mp4
  scaling_bench           rays/s and scaling efficiency over mesh shapes
  measure_dyn_replication the work a gauss-sharded dynamic step replicates
  multihost_smoke         the dry run over processes joined by RODYGS_*
  sort_microbench         the fragment sort at 1080p's capacities
  bench                   the static train step's Mpix/s (bench.py's metric)

The tools that compute run on `cuda` unless given `--device cpu`.
"""
