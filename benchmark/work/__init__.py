"""The operations and bytes of the kernels whose rooflines the benchmark
reads (one file per metric), and the card's peaks."""
