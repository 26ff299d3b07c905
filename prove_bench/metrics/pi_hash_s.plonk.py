"""The plonk prover's host hash of the public inputs: seconds a proof in the program's
"hash public inputs" timing scope, mean over the window's proofs."""

SCOPE = "hash public inputs"


def read(ctx):
    return ctx.scope_seconds_per_proof(SCOPE)
