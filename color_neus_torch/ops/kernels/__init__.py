"""The port's hand-written CUDA kernels: the wrapper modules, the build.

Every wrapper counts its launches in `<wrapper>.launches`; launch_counts
reads them all.
"""

from __future__ import annotations


def launchers() -> dict:
    """{name: wrapper} of every kernel the port launches."""
    from color_neus_torch.ops.kernels import mlp_chain, point_pipeline, ray_march
    from color_neus_torch.ops.kernels.sdf_mlp import launch_sdf_points
    from color_neus_torch.ops.kernels.sdf_rays import launch_sdf_rays
    return {"sdf_rays": launch_sdf_rays, "sdf_points": launch_sdf_points,
            "point_pipeline": point_pipeline.launch_point_pipeline,
            "point_pipeline_bwd": point_pipeline.launch_point_pipeline_bwd,
            "ray_march": ray_march.launch_ray_march,
            "ray_march_bwd": ray_march.launch_ray_march_bwd,
            "ray_march_save": ray_march.launch_ray_march_save,
            "ray_march_bwd_load": ray_march.launch_ray_march_bwd_load,
            "mlp_chain": mlp_chain.launch_chain,
            "mlp_chain_deferred": mlp_chain.launch_chain_deferred}


def launch_counts() -> dict:
    """{name: launches so far} of every kernel wrapper."""
    return {name: fn.launches for name, fn in launchers().items()}
