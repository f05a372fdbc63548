#!/usr/bin/env bash
# Backend-matrix test runner (the analogue of the reference's feature-
# matrix CI, run_tests.sh:8-47 / SURVEY §4):
#
#   ./run_tests.sh            # CPU jax on the virtual 8-device mesh
#   ./run_tests.sh device     # numeric-parity subset on an NVIDIA GPU
#   ./run_tests.sh asan       # native-codec fuzz corpus under ASan
#   ./run_tests.sh pyxtc      # trajectory suite on the pure-Python XTC
#                             # backend (cross-backend validation axis)
#   ./run_tests.sh examples   # execute every examples/*.py against the
#                             # fixture corpus (the reference runs its
#                             # doc examples as tests, run_doc_tests.sh)
#   ./run_tests.sh all        # all of the above
set -euo pipefail
cd "$(dirname "$0")"

mode="${1:-cpu}"

run_cpu() {
  echo "== CPU suite (virtual 8-device mesh) =="
  python -m pytest tests/ -q
}

run_pyxtc() {
  echo "== trajectory suite under GROAN_XTC_BACKEND=py =="
  GROAN_XTC_BACKEND=py python -m pytest \
    tests/test_traj.py tests/test_xtc_backend_py.py tests/test_triclinic.py -q
}

run_device() {
  echo "== device_parity subset on the GPU =="
  GROAN_TEST_PLATFORM=gpu python -m pytest tests/ -m device_parity -q
}

run_asan() {
  echo "== native codec fuzz under AddressSanitizer =="
  python tests/asan_fuzz.py
}

run_examples() {
  # the reference treats its doc examples as tests (run_doc_tests.sh);
  # ours is the examples/ directory — every script must exit 0 against
  # the fixture corpus, so examples cannot silently rot as the API moves
  echo "== examples against the fixture corpus =="
  local fail=0
  for ex in examples/*.py; do
    echo "-- $ex"
    if ! JAX_PLATFORMS=cpu \
         XLA_FLAGS="--xla_force_host_platform_device_count=8" \
         timeout 600 python "$ex" > /tmp/groan_example.log 2>&1; then
      echo "FAILED: $ex"
      tail -20 /tmp/groan_example.log
      fail=1
    fi
  done
  [ "$fail" -eq 0 ] && echo "all examples passed"
  return $fail
}

case "$mode" in
  cpu) run_cpu ;;
  device) run_device ;;
  asan) run_asan ;;
  pyxtc) run_pyxtc ;;
  examples) run_examples ;;
  all) run_cpu; run_device; run_asan; run_pyxtc; run_examples ;;
  *) echo "usage: $0 [cpu|device|asan|pyxtc|examples|all]" >&2; exit 2 ;;
esac
