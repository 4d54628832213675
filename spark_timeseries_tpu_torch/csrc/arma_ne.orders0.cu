// The kernels of csrc/arma_ne.cuh for 3 of the 36 orders p, q <= 5;
// the orders files share them out so that their nvcc runs, started
// together, take about the same time.

#include "arma_ne_rows.cuh"

namespace arma_ne {

ARMA_NE_ORDER(2, 3)
ARMA_NE_ORDER(4, 0)
ARMA_NE_ORDER(5, 5)

}  // namespace arma_ne
