"""The command-line tools of the port, one module per tool of the JAX
package's tools/ (itself one per executable of libde265), each run as

    python -m libde265_tpu_torch.tools.<name> [arguments]

    dec265              decode a stream to YUV; check SEI hashes, PSNR
    enc265              encode a 4:2:0 YUV with the port's encoder
    decodestreams       decode every stream of a directory (a sweep)
    acceleration_speed  check and time device ops against their references
    sherlock            a stream's structure overlays as one HTML file
    hdrcopy             dump a stream's headers, copy its parameter sets
    rd_curves           rate-distortion points of the port's encoder
    bjontegaard         BD-PSNR and BD-rate between two RD curves

and the measurement tools, one per harness of the JAX package (its root
bench.py and tools/bench_*.py, tools/profile_*.py):

    bench               bench.py's protocol: parse, pack, an MD5-checked
                        round, serial rounds, the sustained rate with
                        spawned parse+pack workers over shared memory
    bench_e2e           decode_stream_native (or numpy) fps, stage split
    bench_frontend      native parse and plan-extraction rates
    bench_gop           GOP-parallel decode scaling with spawned workers
    bench_gop_device    the GOP stream pipelined; the GOP decoder's copies
    bench_intra_scan    an IDR through K4 (and, --fori, wavefront levels)
    profile_frame_stages  P-frame ms with frame-program stages left out
    profile_intra       an IDR's intra: K4 by plane group, the levels
    bench_full_pipeline   a synthetic 4K MC/residual/deblock/SAO chain

The tools that decode or measure run on the card ("cuda") unless
`--device cpu` is given; enc265, hdrcopy, bjontegaard and
bench_frontend do host work only. Each module's main(argv) returns the
exit code, so a caller may drive it in-process.
"""
