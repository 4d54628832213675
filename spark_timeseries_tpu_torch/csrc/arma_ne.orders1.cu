// The kernels of csrc/arma_ne.cuh for 4 of the 36 orders p, q <= 5;
// the orders files share them out so that their nvcc runs, started
// together, take about the same time.

#include "arma_ne_rows.cuh"

namespace arma_ne {

ARMA_NE_ORDER(1, 1)
ARMA_NE_ORDER(2, 2)
ARMA_NE_ORDER(4, 3)
ARMA_NE_ORDER(4, 5)

}  // namespace arma_ne
