// The kernels of csrc/arma_ne.cuh for 5 of the 36 orders p, q <= 5;
// the orders files share them out so that their nvcc runs, started
// together, take about the same time.

#include "arma_ne_rows.cuh"

namespace arma_ne {

ARMA_NE_ORDER(0, 4)
ARMA_NE_ORDER(0, 5)
ARMA_NE_ORDER(1, 5)
ARMA_NE_ORDER(3, 0)
ARMA_NE_ORDER(3, 3)

}  // namespace arma_ne
