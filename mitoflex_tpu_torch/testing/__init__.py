"""Seeded synthetic inputs (reads, genomes, a profile set) for smoke runs and tests."""
