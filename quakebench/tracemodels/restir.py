"""ReSTIR DI: one nearest trace a sample, and the visibility traces of the
bias corrections that trace (mode 2) and of the shading; each visibility
trace is two where the scene has alpha-tested triangles (the any-hit
table and the alpha-tested table's trace beside it)."""


def traces(cfg: dict, px: int, alpha: bool) -> list:
    fields = (cfg.get("integrator_config") or {}).get("fields", {})
    out = [(px, True)] * fields.get("spp", 1)
    vis = []
    if fields.get("temporal_bias_correction", 0) == 2:
        vis.append(px)
    if fields.get("spatial_bias_correction", 0) == 2:
        vis += [px] * fields.get("spatial_reuse_iterations", 1)
    if fields.get("visibility_shade", True):
        vis.append(px)
    for n in vis:
        out.append((n, False))
        if alpha:
            out.append((n, True))
    return out
