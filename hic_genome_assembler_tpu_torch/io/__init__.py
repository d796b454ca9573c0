"""Host-side I/O: HiC-Pro ingestion, the intermediate file bus, FASTA."""
