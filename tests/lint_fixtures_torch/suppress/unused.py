"""A suppression that matches nothing is itself a finding."""
import time

# nf-lint: disable=wall-clock -- nothing below reads the wall clock
MONO = time.monotonic()
