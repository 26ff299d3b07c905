"""Work counts of the statements the benchmark proves, from their
parameters alone, and the card's peaks: the yardstick of the roofline
metrics."""
