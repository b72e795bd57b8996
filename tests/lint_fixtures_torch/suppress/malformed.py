"""Malformed suppression: the mandatory -- reason is missing."""
import time

STAMP = time.time()  # nf-lint: disable=wall-clock
