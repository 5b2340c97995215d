"""One module a kind of traffic mix (the mix's ``kind``), each with
``drives(params, rng)``: one request's drives under the mix."""
