"""The scripted player of ``cli play`` in a live game: the scene maker
returns the game (a ``LiveGame``, or a tuple that starts with it); each
frame runs the game step (``step_dynamic``, the player walking
``forward`` at yaw ``first_yaw(seed) + yaw_step * i``), then the refresh
of the live tables' dynamic suffix (``refresh_dynamic``), then the
frame. The mix's ``live`` gives ``dt``, ``forward`` and ``yaw_step``;
the tables' dynamic capacity is the game's (the maker's
``dynamic_capacity``)."""
from __future__ import annotations


def first_yaw(seed: int) -> float:
    return (seed % 3600) / 10.0


class Program:
    def __init__(self, made, mix: dict, seed: int, device, spans):
        from merian_quake_tpu_torch.accel.build import build_accel_live

        self.game = made[0] if isinstance(made, tuple) else made
        self.bundle = self.game.gs.static_bundle
        self.la = build_accel_live(self.bundle, dyn_cap=self.game.gs.dynamic_capacity,
                                   device=device)
        self.accel = self.la.accel
        self.live, self.seed, self.spans = mix["live"], seed, spans
        self.dyn = None

    def inputs(self, i: int):
        lv = self.live
        self.dyn, u = self.spans("step_dynamic", self.game.step_dynamic, dt=lv["dt"],
                                 forward=lv["forward"],
                                 yaw=first_yaw(self.seed) + lv["yaw_step"] * i)
        return u

    def before_replay(self, cf):
        from merian_quake_tpu_torch.accel.build import refresh_dynamic

        self.spans("refresh_dynamic", refresh_dynamic, self.la, self.dyn, sync=True)

    def step_input(self):
        return self.dyn

    def tables(self) -> dict:
        """The live tables' dynamic suffix as the last refresh wrote it
        (host copies), keyed as the reference's ``dynamic_rows``; each Woop
        table's packed rows (what the kernels read) under ``<key>.rows4``."""
        from merian_quake_tpu_torch.accel import woop
        from merian_quake_tpu_torch.models.types import CLUSTER_SIZE
        from quakebench.reference.accel.build import DYN_SCENE_FIELDS

        a, t0, cap = self.la.accel, self.la.n_static, self.la.dyn_cap
        c0, nc = t0 // CLUSTER_SIZE, cap // CLUSTER_SIZE
        rows = {key: getattr(a.scene, field)[t0:t0 + cap] for field, key in DYN_SCENE_FIELDS}
        rows.update(cand=a.candidate[t0:t0 + cap], needs_alpha=a.needs_alpha[t0:t0 + cap],
                    attr=a.tri_attr[t0:t0 + cap], lo=a.cluster_lo[c0:c0 + nc],
                    hi=a.cluster_hi[c0:c0 + nc], lo_a=a.cluster_lo_alpha[c0:c0 + nc],
                    hi_a=a.cluster_hi_alpha[c0:c0 + nc])
        for key, w in (("w", a.woop_w), ("w_shadow", a.woop_w_shadow),
                       ("w_alpha", a.woop_w_alpha)):
            rows[key] = w[3 * t0:]
            rows[key + ".rows4"] = woop.packed_rows(w)[3 * t0:]
        return {k: v.detach().clone().cpu() for k, v in rows.items()}

    def release(self):
        for k in ("la", "accel", "game"):
            self.__dict__.pop(k, None)


class Reference:
    def __init__(self, scene, atlas, mix: dict, device):
        from quakebench.reference.accel import build as rb

        self.la = rb.build_accel_live(scene, atlas, mix["scene"]["args"]["dynamic_capacity"],
                                      device)
        self.accel = self.la.accel

    def follow(self, dyn: dict) -> dict:
        """Write the game step's dynamic block into the reference's tables;
        returns its rows of every table (to hold the program's to)."""
        from quakebench.reference.accel import build as rb

        rows = rb.dynamic_rows(self.la, dyn)
        rb.apply_dynamic(self.la, rows)
        for key in ("w", "w_shadow", "w_alpha"):
            rows[key + ".rows4"] = rows[key][:, :4]
        return rows
