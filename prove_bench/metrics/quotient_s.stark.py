"""The STARK prover's quotient pass: seconds a proof in the program's
"quotient values + coefficients" timing scope, mean over the window's proofs."""

SCOPE = "quotient values + coefficients"


def read(ctx):
    return ctx.scope_seconds_per_proof(SCOPE)
