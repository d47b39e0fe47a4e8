"""``stencil_fingerprint``, the one part of the reference's
``api/schedule_cache.py`` that the port has: the identity of a stencil or
program, which keys serving buckets and checkpoint directories.  The
schedule cache itself comes with autotuning (ROADMAP A11)."""
from __future__ import annotations

import hashlib


def stencil_fingerprint(st) -> str:
    """Hash of what makes a stencil *itself*: name alone is not identity for
    user-defined stencils, whose ``apply`` can change under the same name.

    A multi-stage :class:`~repro_torch.programs.StencilProgram`
    fingerprints as the ordered chain of its stages: each stage's stencil
    fingerprint plus its static coefficient overrides and per-stage BC;
    DAG wiring (explicit ``inputs=``, extra ``fields=``, ``updates=``) folds
    in only when present.  The same stencil or program gives the
    reference's hex digest, so bucket keys agree across the packages."""
    if hasattr(st, "stages"):    # StencilProgram
        h = hashlib.sha1()
        for s in st.stages:
            btok = (s.boundary.token() if hasattr(s.boundary, "token")
                    else repr(s.boundary))
            h.update(stencil_fingerprint(s.stencil).encode())
            h.update(repr((s.name, s.coeffs, btok)).encode())
            if s.inputs is not None:
                h.update(repr(("inputs", s.inputs)).encode())
        if st.fields != ("u",) or st.updates is not None:
            h.update(repr(("state", st.fields, st.updates)).encode())
        return h.hexdigest()[:8]
    h = hashlib.sha1()
    h.update(repr((st.ndim, st.radius, st.flop_pcu, st.num_read,
                   st.num_write, st.has_aux, st.coeff_names,
                   st.offsets)).encode())
    if getattr(st, "arity", 1) != 1:
        h.update(repr(("arity", st.arity)).encode())
    code = getattr(st.apply, "__code__", None)
    if code is not None:
        h.update(code.co_code)
        # nested code objects repr with process-dependent addresses: skip
        h.update(repr([c for c in code.co_consts
                       if not hasattr(c, "co_code")]).encode())
    return h.hexdigest()[:8]
