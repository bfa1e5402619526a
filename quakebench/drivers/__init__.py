"""Drivers: how a traffic mix moves its world from frame to frame, one
module a kind, found by the mix's ``driver`` name
(``quakebench/drivers/<name>.py``).

Each such module defines two classes, each given the whole mix:

- ``Program(made, mix, seed, device, spans)``: the program's side.
  ``made`` is what the mix's scene maker returned; the module takes the
  scene bundle from it (``.bundle``) and builds the tables the frame
  traces (``.accel``). ``inputs(i)`` gives frame ``i``'s uniforms,
  ``before_replay(cf)`` runs what the frame needs after them and before
  the replay of the compiled frame ``cf`` (which it may write tables
  into), ``step_input()`` is what the reference
  needs of that frame's world step (None where there is none),
  ``tables()`` the program's tables that this step wrote (host copies,
  None where it writes none), ``release()`` drops the device memory.
- ``Reference(scene, atlas, mix, device)``: the plain reference's
  side, its own tables (``.accel``) built from the scene's triangles and
  the reference's own atlas; ``follow(step_input)`` applies the same
  world step and returns the rows it wrote, keyed as ``tables()``.

A new kind of traffic (an orbit camera, a demo replay) is a new module.
"""
