"""Tiny QuakeC bytecode assembler: builds progs.dat v6 images in-memory.

The game host (native/game/) executes real progs.dat files; tests can't
ship id1's compiled game code, so this assembler produces miniature
progs with the same binary layout — enough to exercise the VM opcode
set, builtin dispatch, spawn functions, think chains and the physics
ABI (movetype/solid/velocity fields).

Copy of merian_quake_tpu/game/qcasm.py (jax-free numpy).
"""
from __future__ import annotations

import struct

# ev_* types
EV_VOID, EV_STRING, EV_FLOAT, EV_VECTOR, EV_ENTITY, EV_FIELD, EV_FUNCTION, \
    EV_POINTER = range(8)

# opcodes (progs v6 order)
(OP_DONE, OP_MUL_F, OP_MUL_V, OP_MUL_FV, OP_MUL_VF, OP_DIV_F, OP_ADD_F,
 OP_ADD_V, OP_SUB_F, OP_SUB_V, OP_EQ_F, OP_EQ_V, OP_EQ_S, OP_EQ_E, OP_EQ_FNC,
 OP_NE_F, OP_NE_V, OP_NE_S, OP_NE_E, OP_NE_FNC, OP_LE, OP_GE, OP_LT, OP_GT,
 OP_LOAD_F, OP_LOAD_V, OP_LOAD_S, OP_LOAD_ENT, OP_LOAD_FLD, OP_LOAD_FNC,
 OP_ADDRESS, OP_STORE_F, OP_STORE_V, OP_STORE_S, OP_STORE_ENT, OP_STORE_FLD,
 OP_STORE_FNC, OP_STOREP_F, OP_STOREP_V, OP_STOREP_S, OP_STOREP_ENT,
 OP_STOREP_FLD, OP_STOREP_FNC, OP_RETURN, OP_NOT_F, OP_NOT_V, OP_NOT_S,
 OP_NOT_ENT, OP_NOT_FNC, OP_IF, OP_IFNOT, OP_CALL0, OP_CALL1, OP_CALL2,
 OP_CALL3, OP_CALL4, OP_CALL5, OP_CALL6, OP_CALL7, OP_CALL8, OP_STATE,
 OP_GOTO, OP_AND, OP_OR, OP_BITAND, OP_BITOR) = range(66)

OFS_RETURN = 1
OFS_PARM0 = 4

# the standard builtin numbers (id1 ABI)
BUILTINS = {
    "makevectors": 1, "setorigin": 2, "setmodel": 3, "setsize": 4,
    "random": 7, "sound": 8, "normalize": 9, "error": 10, "objerror": 11,
    "vlen": 12, "vectoyaw": 13, "spawn": 14, "remove": 15, "traceline": 16,
    "checkclient": 17, "find": 18, "precache_sound": 19, "precache_model": 20,
    "stuffcmd": 21, "findradius": 22, "bprint": 23, "sprint": 24,
    "dprint": 25, "ftos": 26, "vtos": 27, "walkmove": 32, "droptofloor": 34,
    "lightstyle": 35, "rint": 36, "floor": 37, "ceil": 38, "checkbottom": 40,
    "pointcontents": 41, "fabs": 43, "aim": 44, "cvar": 45, "localcmd": 46,
    "nextent": 47, "particle": 48, "ChangeYaw": 49, "vectoangles": 51,
    "movetogoal": 67, "precache_file": 68, "makestatic": 69,
    "changelevel": 70, "cvar_set": 72, "centerprint": 73, "ambientsound": 74,
    "setspawnparms": 78,
}

# standard entvars every progs defines (subset the engine requires +
# what the tests poke); order defines field offsets
STD_FIELDS = [
    ("modelindex", EV_FLOAT), ("absmin", EV_VECTOR), ("absmax", EV_VECTOR),
    ("ltime", EV_FLOAT), ("movetype", EV_FLOAT), ("solid", EV_FLOAT),
    ("origin", EV_VECTOR), ("oldorigin", EV_VECTOR), ("velocity", EV_VECTOR),
    ("angles", EV_VECTOR), ("avelocity", EV_VECTOR),
    ("punchangle", EV_VECTOR), ("classname", EV_STRING),
    ("model", EV_STRING), ("frame", EV_FLOAT), ("skin", EV_FLOAT),
    ("effects", EV_FLOAT), ("mins", EV_VECTOR), ("maxs", EV_VECTOR),
    ("size", EV_VECTOR), ("touch", EV_FUNCTION), ("use", EV_FUNCTION),
    ("think", EV_FUNCTION), ("blocked", EV_FUNCTION),
    ("nextthink", EV_FLOAT), ("groundentity", EV_ENTITY),
    ("health", EV_FLOAT), ("frags", EV_FLOAT), ("weapon", EV_FLOAT),
    ("weaponmodel", EV_STRING), ("weaponframe", EV_FLOAT),
    ("currentammo", EV_FLOAT), ("items", EV_FLOAT),
    ("takedamage", EV_FLOAT), ("chain", EV_ENTITY), ("deadflag", EV_FLOAT),
    ("view_ofs", EV_VECTOR), ("button0", EV_FLOAT), ("button1", EV_FLOAT),
    ("button2", EV_FLOAT), ("impulse", EV_FLOAT), ("fixangle", EV_FLOAT),
    ("v_angle", EV_VECTOR), ("idealpitch", EV_FLOAT), ("netname", EV_STRING),
    ("enemy", EV_ENTITY), ("flags", EV_FLOAT), ("colormap", EV_FLOAT),
    ("team", EV_FLOAT), ("max_health", EV_FLOAT),
    ("teleport_time", EV_FLOAT), ("armortype", EV_FLOAT),
    ("armorvalue", EV_FLOAT), ("waterlevel", EV_FLOAT),
    ("watertype", EV_FLOAT), ("ideal_yaw", EV_FLOAT),
    ("yaw_speed", EV_FLOAT), ("aiment", EV_ENTITY),
    ("goalentity", EV_ENTITY), ("spawnflags", EV_FLOAT),
    ("target", EV_STRING), ("targetname", EV_STRING),
    ("dmg_take", EV_FLOAT), ("dmg_save", EV_FLOAT),
    ("dmg_inflictor", EV_ENTITY), ("owner", EV_ENTITY),
    ("movedir", EV_VECTOR), ("message", EV_STRING), ("sounds", EV_FLOAT),
    ("noise", EV_STRING), ("noise1", EV_STRING), ("noise2", EV_STRING),
    ("noise3", EV_STRING),
]

# standard globals the engine binds (subset)
STD_GLOBALS = [
    ("self", EV_ENTITY), ("other", EV_ENTITY), ("world", EV_ENTITY),
    ("time", EV_FLOAT), ("frametime", EV_FLOAT),
    ("force_retouch", EV_FLOAT), ("mapname", EV_STRING),
    ("deathmatch", EV_FLOAT), ("coop", EV_FLOAT), ("teamplay", EV_FLOAT),
    ("serverflags", EV_FLOAT), ("total_secrets", EV_FLOAT),
    ("total_monsters", EV_FLOAT), ("found_secrets", EV_FLOAT),
    ("killed_monsters", EV_FLOAT), ("parm1", EV_FLOAT),
    ("intermission_running", EV_FLOAT), ("v_forward", EV_VECTOR),
    ("v_up", EV_VECTOR), ("v_right", EV_VECTOR),
    ("trace_allsolid", EV_FLOAT), ("trace_startsolid", EV_FLOAT),
    ("trace_fraction", EV_FLOAT), ("trace_endpos", EV_VECTOR),
    ("trace_plane_normal", EV_VECTOR), ("trace_plane_dist", EV_FLOAT),
    ("trace_ent", EV_ENTITY), ("trace_inopen", EV_FLOAT),
    ("trace_inwater", EV_FLOAT), ("msg_entity", EV_ENTITY),
]

_TYPE_SIZE = {EV_VECTOR: 3}


class Fn:
    """A function being assembled; records statements + local slots."""

    def __init__(self, asm: "QCAsm", name: str, index: int):
        self.asm = asm
        self.name = name
        self.index = index
        self.is_builtin = False
        self.first_statement = -1
        self.numparms = 0
        self.parm_sizes: list[int] = []
        self.parm_start = 0
        self.locals = 0
        self._stmts: list[tuple[int, int, int, int]] = []

    # -- emission helpers --
    def emit(self, op, a=0, b=0, c=0) -> int:
        self._stmts.append((op, a, b, c))
        return len(self._stmts) - 1

    def label(self) -> int:
        """Current statement index (jump target)."""
        return len(self._stmts)

    def patch_goto(self, at: int, target: int):
        op, a, b, c = self._stmts[at]
        if op == OP_GOTO:
            self._stmts[at] = (op, target - at, b, c)
        else:  # IF/IFNOT jump in b
            self._stmts[at] = (op, a, target - at, c)

    def temp(self, size=1) -> int:
        """Allocate a function-local temp global."""
        return self.asm._alloc_local(self, size)

    def call(self, fn_name: str, *args, ret=None):
        """CALLn with float/vector parm moves; returns OFS_RETURN or a
        copy in `ret`."""
        for i, a in enumerate(args):
            ofs, size = a if isinstance(a, tuple) else (a, 1)
            self.emit(OP_STORE_V if size == 3 else OP_STORE_F, ofs,
                      OFS_PARM0 + 3 * i)
        fg = self.asm.fn_global(fn_name)
        self.emit(OP_CALL0 + len(args), fg)
        if ret is not None:
            size = 3 if isinstance(ret, tuple) else 1
            dst = ret[0] if isinstance(ret, tuple) else ret
            self.emit(OP_STORE_V if size == 3 else OP_STORE_F, OFS_RETURN,
                      dst)
        return OFS_RETURN

    def ret(self, ofs=0):
        self.emit(OP_RETURN, ofs)


class QCAsm:
    def __init__(self):
        self.strings = bytearray(b"\0")
        self._string_cache: dict[str, int] = {"": 0}
        self.fields: list[tuple[str, int, int]] = []  # name, type, ofs
        self._field_ofs: dict[str, int] = {}
        self._next_field = 0
        self.globaldefs: list[tuple[str, int, int]] = []
        self._global_ofs: dict[str, int] = {}
        self.globals: list[int] = [0] * 28  # reserved ABI area (raw i32)
        self.functions: list[Fn] = []
        self._fn_globals: dict[str, int] = {}
        self._float_cache: dict[float, int] = {}
        # function index 0 is the null function
        null = Fn(self, "", 0)
        self.functions.append(null)
        for name, ty in STD_FIELDS:
            self.field(name, ty)
        for name, ty in STD_GLOBALS:
            self.global_def(name, ty)
        for name, num in BUILTINS.items():
            self.builtin(name, num)

    # -- strings --
    def string(self, s: str) -> int:
        if s in self._string_cache:
            return self._string_cache[s]
        ofs = len(self.strings)
        self.strings += s.encode("latin-1") + b"\0"
        self._string_cache[s] = ofs
        return ofs

    # -- defs --
    def field(self, name: str, ty: int) -> int:
        if name in self._field_ofs:
            return self._field_ofs[name]
        ofs = self._next_field
        self.fields.append((name, ty, ofs))
        self._field_ofs[name] = ofs
        self._next_field += _TYPE_SIZE.get(ty, 1)
        # the matching global that holds the field offset (".name")
        g = self._alloc_global(name + "#fld", EV_FIELD, 1, register=False)
        self.globals[g] = ofs
        self.globaldefs.append((name, EV_FIELD, g))
        if EV_VECTOR == ty:
            # component defs (name_x/_y/_z) so QC-style vector.comp works
            for k, suffix in enumerate("xyz"):
                gk = self._alloc_global(
                    f"{name}_{suffix}#fld", EV_FIELD, 1, register=False)
                self.globals[gk] = ofs + k
                self.globaldefs.append((f"{name}_{suffix}", EV_FIELD, gk))
        return ofs

    def field_const(self, name: str) -> int:
        """Global offset holding the field offset of `name` (for LOAD)."""
        for dname, ty, g in self.globaldefs:
            if dname == name and ty == EV_FIELD:
                return g
        raise KeyError(name)

    def _alloc_global(self, name, ty, size, register=True) -> int:
        ofs = len(self.globals)
        self.globals += [0] * size
        if register:
            self.globaldefs.append((name, ty, ofs))
            self._global_ofs[name] = ofs
        return ofs

    def global_def(self, name: str, ty: int) -> int:
        if name in self._global_ofs:
            return self._global_ofs[name]
        return self._alloc_global(name, ty, _TYPE_SIZE.get(ty, 1))

    def __getitem__(self, name: str) -> int:
        return self._global_ofs[name]

    def float_const(self, v: float) -> int:
        if v in self._float_cache:
            return self._float_cache[v]
        ofs = self._alloc_global(f"IMM_{v}", EV_FLOAT, 1, register=False)
        self.globals[ofs] = struct.unpack("<i", struct.pack("<f", v))[0]
        self._float_cache[v] = ofs
        return ofs

    def vector_const(self, x, y, z) -> int:
        ofs = self._alloc_global("IMM_VEC", EV_VECTOR, 3, register=False)
        for k, v in enumerate((x, y, z)):
            self.globals[ofs + k] = struct.unpack(
                "<i", struct.pack("<f", float(v)))[0]
        return ofs

    def string_const(self, s: str) -> int:
        ofs = self._alloc_global(f"IMM_S_{s}", EV_STRING, 1, register=False)
        self.globals[ofs] = self.string(s)
        return ofs

    def _alloc_local(self, fn: Fn, size: int) -> int:
        ofs = len(self.globals)
        self.globals += [0] * size
        fn.locals += size
        return ofs

    # -- functions --
    def builtin(self, name: str, num: int):
        fn = Fn(self, name, len(self.functions))
        fn.is_builtin = True
        fn.first_statement = -num
        self.functions.append(fn)
        g = self._alloc_global(name, EV_FUNCTION, 1)
        self.globals[g] = fn.index
        self._fn_globals[name] = g

    def function(self, name: str, parms: list[int] | None = None) -> Fn:
        """Begin a QC function; parms = list of parm sizes (1 or 3)."""
        fn = Fn(self, name, len(self.functions))
        self.functions.append(fn)
        g = self._alloc_global(name, EV_FUNCTION, 1)
        self.globals[g] = fn.index
        self._fn_globals[name] = g
        fn.parm_start = len(self.globals)
        for size in parms or []:
            self._alloc_local(fn, size)
            fn.parm_sizes.append(size)
        fn.numparms = len(fn.parm_sizes)
        return fn

    def fn_global(self, name: str) -> int:
        return self._fn_globals[name]

    def parm_ofs(self, fn: Fn, i: int) -> int:
        ofs = fn.parm_start
        for k in range(i):
            ofs += fn.parm_sizes[k]
        return ofs

    # -- output --
    def build(self) -> bytes:
        statements = []
        for fn in self.functions:
            if fn.is_builtin or fn.index == 0:
                continue
            fn.first_statement = len(statements)
            if not fn._stmts or fn._stmts[-1][0] not in (OP_DONE, OP_RETURN):
                fn._stmts.append((OP_DONE, 0, 0, 0))
            statements.extend(fn._stmts)

        out = bytearray()
        header_size = 15 * 4
        stmt_data = b"".join(
            struct.pack("<H", op) + struct.pack("<hhh",
                                                _s16(a), _s16(b), _s16(c))
            for op, a, b, c in statements
        )
        gdef_data = b"".join(
            struct.pack("<HHi", ty, ofs, self.string(name))
            for name, ty, ofs in self.globaldefs
        )
        fdef_data = b"".join(
            struct.pack("<HHi", ty, ofs, self.string(name))
            for name, ty, ofs in self.fields
        )
        fn_data = b"".join(
            struct.pack(
                "<iiiiiii8B",
                0 if f.index == 0 else f.first_statement,
                f.parm_start, f.locals, 0, self.string(f.name), 0,
                f.numparms, *(f.parm_sizes + [0] * (8 - len(f.parm_sizes))),
            )
            for f in self.functions
        )
        str_data = bytes(self.strings)
        glob_data = b"".join(struct.pack("<i", g) for g in self.globals)

        ofs = header_size
        offsets = {}
        for key, data in [
            ("statements", stmt_data), ("globaldefs", gdef_data),
            ("fielddefs", fdef_data), ("functions", fn_data),
            ("strings", str_data), ("globals", glob_data),
        ]:
            offsets[key] = ofs
            ofs += len(data)

        out += struct.pack(
            "<iiiiiiiiiiiiiii",
            6, 0,
            offsets["statements"], len(statements),
            offsets["globaldefs"], len(self.globaldefs),
            offsets["fielddefs"], len(self.fields),
            offsets["functions"], len(self.functions),
            offsets["strings"], len(str_data),
            offsets["globals"], len(self.globals),
            self._next_field,
        )
        out += stmt_data + gdef_data + fdef_data + fn_data + str_data
        out += glob_data
        return bytes(out)


def _s16(v: int) -> int:
    v &= 0xFFFF
    return v - 0x10000 if v >= 0x8000 else v
