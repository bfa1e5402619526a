"""MCPG: each bounce segment of each surface sample is a nearest trace
(max_path_length - 1 of them a sample), and with the volume pass each of
its samples a scatter trace. Shadows are taken from the guiding's light
cache, not traced."""


def traces(cfg: dict, px: int, alpha: bool) -> list:
    r = cfg["render"]
    fields = (cfg.get("integrator_config") or {}).get("fields", {})
    out = [(px * r["spp"], True)] * max(r["max_path_length"] - 1, 0)
    vol = fields.get("volume")
    if vol:
        out += [(px, True)] * vol["fields"]["volume_spp"]
    return out
