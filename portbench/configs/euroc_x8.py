"""euroc_x8: eight stereo streams through one MultiTracker on one card,
detection on the rig's distorted images, a LocalMapper each (in this
process)."""


def build(cfg: dict, device):
    from portbench.drivers import MultiDriver
    from tpuslam_torch.backend.mapping import MapperConfig
    from tpuslam_torch.frontend.frame import FrontendParams
    from tpuslam_torch.frontend.tracking import TrackerConfig
    from tpuslam_torch.geometry.camera import Distortion, Intrinsics
    from tpuslam_torch.parallel.multi_seq import MultiTracker

    rig = cfg["rig"]
    cam = Intrinsics(*(rig[k] for k in ("fx", "fy", "cx", "cy", "width", "height", "baseline")))
    dist = Distortion(*(rig[k] for k in ("k1", "k2", "p1", "p2")))
    tcfg = TrackerConfig(frontend=FrontendParams(dist=dist, cam=cam))
    mcfg = MapperConfig()
    mcfg.ba = mcfg.ba._replace(lm=mcfg.ba.lm._replace(**cfg["ba_lm"]))
    return MultiDriver(MultiTracker([cam] * int(cfg["sequences"]), tcfg, device=device, mapper_cfg=mcfg), device)
