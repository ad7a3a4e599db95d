"""Published peaks of the chips the benchmark runs on (NVIDIA's data sheet,
H100 SXM, dense, at the 700 W limit)."""

H100_SXM = {
    "hbm_bytes_per_s": 3.35e12,
}
