"""A still camera over a static scene: the scene maker returns a scene
bundle; every frame renders it from the bundle's own camera, with the
frame index as its only change (the accumulation runs on). There is no
world step and no table written after set-up."""
from __future__ import annotations


class Program:
    def __init__(self, made, mix: dict, seed: int, device, spans):
        from merian_quake_tpu_torch.accel.build import build_accel

        self.bundle = made
        self.accel = build_accel(self.bundle.scene, self.bundle.atlas, device=device)

    def inputs(self, i: int):
        return self.bundle.uniforms._replace(frame=i)

    def before_replay(self, cf):
        pass

    def step_input(self):
        return None

    def tables(self):
        return None

    def release(self):
        self.__dict__.pop("accel", None)


class Reference:
    def __init__(self, scene, atlas, mix: dict, device):
        from quakebench.reference.accel import build as rb

        self.accel = rb.build_accel(scene, atlas, device)

    def follow(self, step_input):
        return None
