"""Build the C++ front end (native/libhevc_frontend.so, gitignored) once,
before any test starts. Under pytest-xdist the controller runs this hook
before it starts the workers, so no worker finds the library missing or
half written."""


def pytest_configure(config):
    from libde265_tpu_torch import _build
    _build.ensure_frontend()
