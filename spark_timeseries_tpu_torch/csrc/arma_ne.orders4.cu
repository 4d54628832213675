// The kernels of csrc/arma_ne.cuh for 5 of the 36 orders p, q <= 5;
// the orders files share them out so that their nvcc runs, started
// together, take about the same time.

#include "arma_ne.cuh"

namespace arma_ne {

ARMA_NE_ORDER(0, 1)
ARMA_NE_ORDER(0, 3)
ARMA_NE_ORDER(2, 5)
ARMA_NE_ORDER(3, 2)
ARMA_NE_ORDER(4, 4)

}  // namespace arma_ne
