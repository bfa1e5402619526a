"""SSMM: one nearest trace a sample, every pixel's bounce ray, live or
not; the pass traces no shadow ray."""


def traces(cfg: dict, px: int, alpha: bool) -> list:
    return [(px * cfg["render"]["spp"], True)]
