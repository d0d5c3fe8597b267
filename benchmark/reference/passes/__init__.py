"""The lifecycle's host passes (fracture, weld, simplify, corners, ridge
and raft, fusion) and their host view: frozen copies of
``subzero_tpu_torch/processes/{fracture,weld,simplify,corners,ridge_raft,
fuse,host}.py`` and ``hostgeom.py`` (with ``init.py:_clip_halfplane``) at
commit 61c7962, with their imports pointed at the reference's own polygon
engine (``reference/polyboolean.py``).  They import nothing of the
program, so a later change to the program's passes is held against the
passes as they were."""
