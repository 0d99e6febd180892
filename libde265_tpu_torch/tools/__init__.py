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

The tools that decode run on the card ("cuda") unless `--device cpu` is
given; enc265, hdrcopy and bjontegaard do host work only. Each module's
main(argv) returns the exit code, so a caller may drive it in-process.
"""
