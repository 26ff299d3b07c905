"""The plonk prover's FRI opening proof: seconds a proof in the program's
"compute opening proofs (FRI)" timing scope, mean over the window's proofs."""

SCOPE = "compute opening proofs (FRI)"


def read(ctx):
    return ctx.scope_seconds_per_proof(SCOPE)
