"""The plonk prover's witness generation: seconds a proof in the program's
"generate witness" timing scope, mean over the window's proofs."""

SCOPE = "generate witness"


def read(ctx):
    return ctx.scope_seconds_per_proof(SCOPE)
