"""One module per kind of statement the benchmark proves.  Each defines a
``Statement`` class (see run.py for the interface) that sets up the
program's prover for a cell, proves one input, and judges a proof with the
plain reference."""
