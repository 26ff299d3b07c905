"""The plonk prover's quotient pass: seconds a proof in the program's
"compute quotient polys" timing scope, mean over the window's proofs."""

SCOPE = "compute quotient polys"


def read(ctx):
    return ctx.scope_seconds_per_proof(SCOPE)
