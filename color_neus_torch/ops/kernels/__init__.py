"""The port's hand-written CUDA kernels: the wrapper modules, the build.

Every wrapper counts its launches in `<wrapper>.launches`; launch_counts
reads them all.
"""

from __future__ import annotations


def launchers() -> dict:
    """{name: wrapper} of every kernel the port launches; the point-pipeline
    and march wrappers' kernels of the non-default MARCH_BWD_PRECISION
    modes count apart, under the wrapper's name and the mode's suffix
    (point_pipeline.SUFFIX; their counters, not wrappers)."""
    from color_neus_torch.ops.kernels import mlp_chain, point_pipeline, ray_march
    from color_neus_torch.ops.kernels.sdf_mlp import launch_sdf_points
    from color_neus_torch.ops.kernels.sdf_rays import launch_sdf_rays
    moded = {"point_pipeline": point_pipeline.launch_point_pipeline,
             "point_pipeline_bwd": point_pipeline.launch_point_pipeline_bwd,
             "ray_march": ray_march.launch_ray_march,
             "ray_march_bwd": ray_march.launch_ray_march_bwd,
             "ray_march_save": ray_march.launch_ray_march_save,
             "ray_march_bwd_load": ray_march.launch_ray_march_bwd_load}
    out = {"sdf_rays": launch_sdf_rays, "sdf_points": launch_sdf_points}
    for name, fn in moded.items():
        for mode, counter in point_pipeline.mode_counters(fn).items():
            out[name + point_pipeline.SUFFIX[mode]] = counter
    return {**out, "mlp_chain": mlp_chain.launch_chain, "mlp_chain_f32": mlp_chain.launch_chain.f32,
            "mlp_chain_deferred": mlp_chain.launch_chain_deferred}


def launch_counts() -> dict:
    """{name: launches so far} of every kernel wrapper."""
    return {name: fn.launches for name, fn in launchers().items()}
