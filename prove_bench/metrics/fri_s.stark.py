"""The STARK prover's FRI opening proof: seconds a proof in the program's
"FRI opening proof" timing scope, mean over the window's proofs."""

SCOPE = "FRI opening proof"


def read(ctx):
    return ctx.scope_seconds_per_proof(SCOPE)
